"""Serve a small model with batched requests through the decode path (KV
cache, greedy sampling, latency stats): the port of
``examples/serve_batched.py``, ``repro_torch.launch.serve.main`` with the
reference's arguments.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cuda|cpu]
"""
from __future__ import annotations

from ..launch import serve
from .common import device_from_argv

SERVE_ARGV = ["--arch", "gemma2-2b", "--smoke", "--batch", "8",
              "--prompt-len", "12", "--gen", "24", "--cache-len", "64"]


def main(argv=None, latencies=None):
    """The generated tokens, (8, 24) numpy; ``latencies`` as in
    ``serve.main``."""
    dev = device_from_argv(__doc__, argv)
    return serve.main(SERVE_ARGV + ["--device", dev.type],
                      latencies=latencies)


if __name__ == "__main__":
    main()
