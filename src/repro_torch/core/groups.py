"""Group structure bookkeeping for Sparse-Group Lasso (PyTorch port).

``GroupSpec`` carries both views of a contiguous group partition of ``p``
features, as in the JAX package:

* a ragged view (``group_ids`` for segment reductions), and
* a padded dense view (``(G, n_max)`` gather indices + validity mask) that the
  CUDA kernels consume.

Index tensors are int64; ``weights`` (and ``feature_weights`` when present)
are float64 master data, cast to the working dtype at each use.  Every tensor
of one spec lives on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without CUDA an unspecified device raises:
    the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _checked_weights(values, n: int, name: str,
                     positive: bool = True) -> np.ndarray:
    """``values`` as a float64 (n,) array; a wrong shape, or with
    ``positive`` a value that is not > 0, raises ``ValueError``."""
    arr = np.asarray(values, dtype=np.float64)
    if arr.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {arr.shape}")
    if positive and not np.all(arr > 0):
        raise ValueError(f"{name} must be strictly positive")
    return arr


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    sizes: torch.Tensor        # (G,) int64   features per group
    starts: torch.Tensor       # (G,) int64   offset of each (contiguous) group
    group_ids: torch.Tensor    # (p,) int64   group index of each feature
    weights: torch.Tensor      # (G,) float64 group weights (default sqrt(n_g))
    pad_index: torch.Tensor    # (G, n_max) int64 gather indices into [0, p)
    pad_mask: torch.Tensor     # (G, n_max) bool  validity of padded slots
    num_groups: int
    num_features: int
    max_size: int
    uniform: bool              # all groups share one size
    # (p,) bool: features that no valid padded slot covers (a bucketed
    # spec's garbage-bin columns past n_max); derived in ``from_arrays``
    pad_uncovered: torch.Tensor
    # (G,) int64 segment lengths of ``group_sum``: ``sizes``, the last
    # group's run extended over trailing columns no group owns (the zero
    # pad columns of a feature-shard block); derived in ``from_arrays``
    seg_lengths: torch.Tensor
    feature_weights: Optional[torch.Tensor] = None   # (p,) float64 or None

    @property
    def device(self) -> torch.device:
        return self.group_ids.device

    def to(self, device) -> "GroupSpec":
        device = torch.device(device)
        fw = (None if self.feature_weights is None
              else self.feature_weights.to(device))
        return dataclasses.replace(
            self, sizes=self.sizes.to(device), starts=self.starts.to(device),
            group_ids=self.group_ids.to(device),
            weights=self.weights.to(device),
            pad_index=self.pad_index.to(device),
            pad_mask=self.pad_mask.to(device), feature_weights=fw,
            pad_uncovered=self.pad_uncovered.to(device),
            seg_lengths=self.seg_lengths.to(device))

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_arrays(cls, sizes, starts, group_ids, weights, pad_index,
                    pad_mask, feature_weights=None, *, uniform=None,
                    device=None) -> "GroupSpec":
        """Spec from host arrays (the seven children of the reference's
        ``GroupSpec``); the static fields, ``pad_uncovered`` and
        ``seg_lengths`` are derived from them.  Raises if a valid padded
        slot points outside [0, p) or two valid slots cover one feature:
        the fused prox stores each slot's value where the reference
        scatter-adds it.  The sizes may sum to less than p (a feature-shard
        block's trailing pad columns, which its ``group_ids`` give to the
        last group), never to more."""
        device = resolve_device(device)
        sizes = np.asarray(sizes, dtype=np.int64)
        pad_index = np.asarray(pad_index, dtype=np.int64)
        p = int(np.asarray(group_ids).shape[0])
        unowned = p - int(sizes.sum())
        if unowned < 0:
            raise ValueError("the group sizes sum to more than p")
        seg_lengths = sizes.copy()
        if len(seg_lengths):
            seg_lengths[-1] += unowned
        covered = pad_index[np.asarray(pad_mask, dtype=bool)]
        if covered.size and (covered.min() < 0 or covered.max() >= p):
            raise ValueError("a valid padded slot points outside [0, p)")
        cover = np.bincount(covered, minlength=p)
        if (cover > 1).any():
            raise ValueError("two valid padded slots cover one feature")
        if uniform is None:
            uniform = bool(len(sizes) > 0 and (sizes == sizes[0]).all())

        def t(a, dt):
            return torch.as_tensor(np.array(a), dtype=dt, device=device)

        return cls(
            sizes=t(sizes, torch.int64), starts=t(starts, torch.int64),
            group_ids=t(group_ids, torch.int64),
            weights=t(weights, torch.float64),
            pad_index=t(pad_index, torch.int64),
            pad_mask=t(pad_mask, torch.bool),
            num_groups=int(sizes.shape[0]), num_features=p,
            max_size=int(pad_index.shape[1]), uniform=bool(uniform),
            feature_weights=(None if feature_weights is None
                             else t(feature_weights, torch.float64)),
            pad_uncovered=t(cover == 0, torch.bool),
            seg_lengths=t(seg_lengths, torch.int64))

    @classmethod
    def from_sizes(cls, sizes: Sequence[int], weights=None,
                   feature_weights=None, device=None) -> "GroupSpec":
        sizes_np = np.asarray(sizes, dtype=np.int64)
        if sizes_np.ndim != 1 or (sizes_np <= 0).any():
            raise ValueError("group sizes must be a 1-D positive vector")
        G = int(sizes_np.shape[0])
        p = int(sizes_np.sum())
        starts_np = np.concatenate([[0], np.cumsum(sizes_np)[:-1]])
        gid_np = np.repeat(np.arange(G, dtype=np.int64), sizes_np)
        n_max = int(sizes_np.max())
        pad_idx = starts_np[:, None] + np.arange(n_max)[None, :]
        pad_mask = np.arange(n_max)[None, :] < sizes_np[:, None]
        pad_idx = np.where(pad_mask, pad_idx, 0)
        if weights is None:
            w_np = np.sqrt(sizes_np.astype(np.float64))
        else:
            w_np = _checked_weights(weights, G, "weights", positive=False)
        fw_np = (None if feature_weights is None else
                 _checked_weights(feature_weights, p, "feature_weights"))
        return cls.from_arrays(
            sizes_np, starts_np, gid_np, w_np, pad_idx, pad_mask, fw_np,
            uniform=bool((sizes_np == sizes_np[0]).all()), device=device)

    def reweighted(self, group_weights=None,
                   feature_weights=None) -> "GroupSpec":
        """This spec with adaptive ``group_weights`` (G,) and/or
        per-feature l1 ``feature_weights`` (p,) in place of its own, each
        strictly positive; with neither, this spec object itself."""
        spec, dev = self, self.device
        if group_weights is not None:
            spec = dataclasses.replace(spec, weights=torch.as_tensor(
                _checked_weights(group_weights, self.num_groups,
                                 "group_weights"), device=dev))
        if feature_weights is not None:
            spec = dataclasses.replace(spec, feature_weights=torch.as_tensor(
                _checked_weights(feature_weights, self.num_features,
                                 "feature_weights"), device=dev))
        return spec

    @classmethod
    def uniform_groups(cls, num_groups: int, group_size: int,
                       device=None) -> "GroupSpec":
        return cls.from_sizes([group_size] * num_groups, device=device)

    # -- subsetting (for physically reduced problems) -------------------------
    def bucketed_subset(self, feat_keep: np.ndarray, p_bucket: int,
                        g_bucket: int) -> tuple["GroupSpec", np.ndarray]:
        """Reduced spec padded to fixed shapes (p_bucket, g_bucket).

        Padding columns are zero columns of the padded design matrix; they
        sit in the trailing 'garbage bin' group ``g_bucket - 1``, which may
        hold more than ``n_max`` columns (they are all zero, so the truncated
        padded view is exact).  Groups between the kept ones and the bin
        have size 0.  Returns (spec on this spec's device, col_idx)."""
        feat_keep = np.asarray(feat_keep, dtype=bool)
        col_idx = np.nonzero(feat_keep)[0]
        p_kept = len(col_idx)
        if p_kept > p_bucket:
            raise ValueError("p_bucket too small")
        gid_kept = self.group_ids.cpu().numpy()[col_idx]
        kept_groups, inv, counts = np.unique(gid_kept, return_inverse=True,
                                             return_counts=True)
        G_kept = len(kept_groups)
        pad = p_bucket - p_kept
        if G_kept > g_bucket or (G_kept == g_bucket and pad > 0):
            raise ValueError("g_bucket too small")
        w_full = self.weights.cpu().numpy()
        n_max = self.max_size

        sizes = np.zeros(g_bucket, dtype=np.int64)
        sizes[:G_kept] = counts
        weights = np.ones(g_bucket, dtype=np.float64)
        weights[:G_kept] = w_full[kept_groups]

        group_ids = np.full(p_bucket, g_bucket - 1, dtype=np.int64)
        order = np.argsort(inv, kind="stable")
        group_ids[:p_kept] = inv[order]
        col_idx = col_idx[order]
        starts = np.zeros(g_bucket, dtype=np.int64)
        starts[:G_kept] = np.concatenate([[0], np.cumsum(counts)[:-1]])
        if G_kept < g_bucket:
            sizes[g_bucket - 1] = pad        # garbage bin (may exceed n_max)
            starts[g_bucket - 1] = p_kept

        pad_idx = starts[:, None] + np.arange(n_max)[None, :]
        pad_mask = np.arange(n_max)[None, :] < np.minimum(sizes, n_max)[:, None]
        pad_idx = np.where(pad_mask, np.minimum(pad_idx, p_bucket - 1), 0)

        fw = None
        if self.feature_weights is not None:
            fw = np.ones(p_bucket, dtype=np.float64)
            fw[:p_kept] = self.feature_weights.cpu().numpy()[col_idx]

        spec = GroupSpec.from_arrays(sizes, starts, group_ids, weights,
                                     pad_idx, pad_mask, fw, uniform=False,
                                     device=self.device)
        return spec, col_idx


    def subset(self, feat_keep: np.ndarray) -> tuple["GroupSpec", np.ndarray]:
        """Reduced spec over the kept features, on this spec's device.

        Keeps the ORIGINAL group weight for every surviving group (screened
        features are provably zero, so the group norm over the survivors
        equals the group norm over the full group) and the kept features'
        weights.  Returns (spec, col_idx), ``col_idx`` mapping reduced
        columns back to original columns."""
        feat_keep = np.asarray(feat_keep, dtype=bool)
        col_idx = np.nonzero(feat_keep)[0]
        gid = self.group_ids.cpu().numpy()[col_idx]
        kept_groups, counts = np.unique(gid, return_counts=True)
        fw = (None if self.feature_weights is None
              else self.feature_weights.cpu().numpy()[col_idx])
        spec = GroupSpec.from_sizes(
            counts, weights=self.weights.cpu().numpy()[kept_groups],
            feature_weights=fw, device=self.device)
        return spec, col_idx


# ---------------------------------------------------------------------------
# Segment reductions over the ragged view.
# ---------------------------------------------------------------------------

def group_sum(spec: GroupSpec, x: torch.Tensor) -> torch.Tensor:
    """Per-group sums over the last axis: (..., p) -> (..., G); empty
    groups give 0.  The groups are contiguous runs of ``seg_lengths``
    (summing to p), so a segment reduction adds each group's entries in
    feature order and gives the same sums on every run; a scatter-add on
    the card adds through atomics in no fixed order.  Trailing columns no
    group owns (a feature-shard block's zero pads) join the last group's
    run, adding exact 0.0 terms, as the reference's ``group_ids`` does;
    they are not skipped, or every row after the first would shift."""
    rows = x.reshape(-1, spec.num_features).shape[0]
    lengths = (spec.seg_lengths if rows == 1
               else spec.seg_lengths.repeat(rows))
    # unsafe: no check of the lengths against x, which would read them on
    # the host (and break a CUDA graph capture)
    out = torch.segment_reduce(x.reshape(-1), "sum", lengths=lengths,
                               unsafe=True)
    return out.reshape(*x.shape[:-1], spec.num_groups)


def group_norms(spec: GroupSpec, x: torch.Tensor) -> torch.Tensor:
    """Per-group l2 norms -> (G,)."""
    return torch.sqrt(group_sum(spec, x * x))


def group_max_abs(spec: GroupSpec, x: torch.Tensor) -> torch.Tensor:
    """Per-group l_inf norms -> (G,).  An empty group gives -inf, as
    ``jax.ops.segment_max`` does (the -inf initial value is kept)."""
    out = torch.full((spec.num_groups,), float("-inf"), dtype=x.dtype,
                     device=x.device)
    return out.scatter_reduce_(0, spec.group_ids, torch.abs(x), "amax",
                               include_self=True)


def pad_groups(spec: GroupSpec, x: torch.Tensor) -> torch.Tensor:
    """(p,) -> padded (G, n_max); invalid slots are zero."""
    return torch.where(spec.pad_mask, x[spec.pad_index], 0.0)


def broadcast_to_features(spec: GroupSpec, g: torch.Tensor) -> torch.Tensor:
    """(G,) per-group values -> (p,) per-feature values."""
    return g[spec.group_ids]
