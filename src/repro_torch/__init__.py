"""PyTorch/CUDA port of the TLFre sparse-group-lasso system.

``repro_torch.core`` mirrors ``repro.core`` (the JAX reference); its
kernels (``repro_torch.kernels``) are hand-written CUDA for Hopper
(``sm_90a``), built with nvcc at first use.  The package imports torch and
numpy only.  Its entry points run on the CUDA card unless the caller passes
``device='cpu'``.
"""
