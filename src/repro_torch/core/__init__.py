"""TLFre for sparse-group lasso — the PyTorch/CUDA port of ``repro.core``.

Public surface:
  Problem, Plan, SGLSession   problem spec, run config, ``.path`` verb
  GroupSpec                   group bookkeeping (ragged + padded views)
  lambda_max_sgl, dual_scaling_sgl, group_shrink_roots
  tlfre_screen_grid, fista_sgl, sgl_path_batched
"""
from .groups import (GroupSpec, broadcast_to_features, group_max_abs,
                     group_norms, group_sum, pad_groups, resolve_device)
from .fenchel import sgl_penalty, shrink, weighted_l1
from .losses import SQUARED, SquaredLoss, get_loss
from .lambda_max import dual_scaling_sgl, group_shrink_roots, lambda_max_sgl
from .estimation import normal_vector_sgl, project_out_normal
from .screening import grid_ball_geometry, sup_shrink_norm, tlfre_screen_grid
from .prox import sgl_prox
from .linalg import (column_norms, group_frobenius_norms,
                     group_spectral_norms, spectral_norm)
from .solver import SolveResult, fista_sgl
from .path import PathResult, default_lambda_grid
from .path_engine import EngineStats, sgl_path_batched
from .problem import Plan, Problem, as_group_spec
from .session import SGLSession

__all__ = [n for n in dir() if not n.startswith("_")]
