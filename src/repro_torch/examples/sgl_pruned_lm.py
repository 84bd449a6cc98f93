"""End-to-end driver on the port: train a ~100M-parameter gemma2-style LM
with SGL-regularised structured sparsity, then draw the pruning-threshold
curve of its FFN channels with the batched path engine (the port of
``examples/sgl_pruned_lm.py``).

The model is a 12-layer gemma2-family decoder (d 512, 8 heads, 4 KV heads,
d_ff 2048, vocabulary 32 768, window 256); training uses the deterministic
synthetic LM stream.  Every step applies the exact two-level SGL prox to the
attention-head / FFN-channel weight groups.  The curve is the SGL path of
the group-level linearised subproblem (an identity design, one unit column
per channel, the channels' norms as the response): at each lambda the
surviving channels are those whose signal exceeds that pruning threshold.
On the card in float32 it launches ``xtv``, ``screen_norms`` and graphed
``sgl_prox`` blocks.

    PYTHONPATH=src python -m repro_torch.examples.sgl_pruned_lm \\
        [--steps 200] [--device cuda|cpu] [--smoke]

``--smoke`` trains the config's reduced same-family version (``.reduced()``:
2 layers, d 64, vocabulary 256), which runs on the CPU in seconds.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs.base import get_config, register
from ..launch import train as train_mod
from ..sparsity.group_reg import leaf_group_norms


def pruning_threshold_curve(group_signal: np.ndarray, alpha: float = 1.0,
                            n_lambdas: int = 24, device=None,
                            dtype=torch.float32):
    """Lambda path of the group-level linearised subproblem: ``sgl_path``
    on the batched engine over ``X = eye(G)``, ``y = group_signal``, one
    group a column; ``device=None`` is the card.  Returns (PathResult,
    surviving groups per lambda)."""
    from ..core import GroupSpec, sgl_path

    G = len(group_signal)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    X = np.eye(G, dtype=np_dt)
    y = np.asarray(group_signal, np_dt)
    spec = GroupSpec.uniform_groups(G, 1, device="cpu")
    res = sgl_path(X, y, spec, alpha, n_lambdas=n_lambdas, tol=1e-8,
                   max_iter=2000, check_every=20, engine="batched",
                   min_bucket=16, device=device, dtype=dtype)
    surviving = (np.abs(res.betas) > 1e-9).sum(axis=1)
    return res, surviving


def example_config():
    """The ~100M-parameter config of the gemma2 family, registered into the
    port's registry as ``gemma2-100m``."""
    cfg = dataclasses.replace(
        get_config("gemma2-2b"), name="gemma2-100m", num_layers=12,
        d_model=512, num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32768, window_size=256)
    return register(cfg)


def ffn_channel_signal(params) -> np.ndarray | None:
    """Channel norms of the first block kind's ``ffn/w_in`` (over its stack
    and input axes), or None without such a leaf."""
    for lname in params["blocks"].keys():
        ltree = params["blocks"][lname]
        if "ffn" in ltree and "w_in" in ltree["ffn"]:
            w_in = ltree["ffn"]["w_in"].detach()
            return leaf_group_norms(w_in, w_in.ndim - 1).cpu().numpy()
    return None


def train_argv(steps: int, device: str, smoke: bool = False) -> list:
    """``train.main``'s arguments for the example's run."""
    return ["--arch", "gemma2-100m", "--steps", str(steps),
            "--global-batch", "8", "--seq", "256", "--lr", "1e-3",
            "--sgl-lambda", "3e-4", "--sgl-alpha", "1.0",
            "--log-every", "25", "--device", device] + \
        (["--smoke"] if smoke else [])


def main(argv=None, step_times=None):
    """Returns a dict: losses, state, and (with an FFN) the channel signal,
    the curve's PathResult and its surviving counts.  ``step_times`` as in
    ``train.main``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced same-family config instead")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    example_config()
    losses, state = train_mod.main(
        train_argv(args.steps, args.device, args.smoke), return_state=True,
        step_times=step_times)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss must decrease: {losses[0]:.4f} -> "
                           f"{losses[-1]:.4f}")
    print("OK: loss decreased with SGL structured sparsity active")
    out = {"losses": losses, "state": state}

    # --- pruning-threshold curve via the batched path engine --------------
    signal = ffn_channel_signal(state.params)
    if signal is None:
        print("no ffn/w_in leaf found; skipping path report")
        return out
    res, surviving = pruning_threshold_curve(signal, device=args.device)
    st = res.stats
    print("\npruning-threshold curve (FFN channels surviving vs lambda):")
    for j in range(0, len(res.lambdas), 4):
        print(f"  lam/lam_max {res.lambdas[j]/res.lam_max:6.3f}   "
              f"channels {surviving[j]:5d} / {len(signal)}")
    print(f"computed by the batched engine in "
          f"{st.n_segments + st.n_screens} device round-trips "
          f"({st.n_compilations} solver compilations)")
    out.update(signal=signal, curve=res, surviving=surviving)
    return out


if __name__ == "__main__":
    main()
