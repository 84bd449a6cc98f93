"""Numpy-tree checkpointer: atomic, async, step-indexed (PyTorch port of
``repro.checkpoint.checkpointer``).

Layout, the reference's:  <dir>/step_<N>/
           manifest.json      structure + shapes/dtypes + metadata
           arrays.npz         flattened leaves (``leaf_<i>``, in the
                              reference's flatten order: ``repro_torch.pytree``)
A checkpoint directory is written under a temp name and renamed into place
(atomic on POSIX), so a crash mid-write never leaves a directory that loads.
A checkpoint either package writes restores in the other.
``AsyncCheckpointer`` copies the state to host memory synchronously and
writes it on a worker thread: the optimizer updates its tensors in place, so
a lazily read tensor would race with the next step.

Elastic resume: leaves are written whole.  On a mesh of several ranks
``save`` (and ``AsyncCheckpointer.save``) gathers each leaf from the ranks'
blocks (``shardings``), rank 0 writes and the others wait at a barrier;
``restore`` with ``shardings`` reads the whole arrays and keeps each leaf's
block for this rank.  So a checkpoint written on one mesh restores onto any
other, onto no mesh, and into the reference's ``restore``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch

from ..pytree import flatten, leaves as tree_leaves, plain_structure, \
    unflatten


def _is_sharding(x) -> bool:
    return hasattr(x, "local") and hasattr(x, "spec")


def _lead(shardings) -> tuple:
    """(this rank writes, the mesh's size) for a tree of shardings."""
    if shardings is None:
        return True, 1
    mesh = tree_leaves(shardings, is_leaf=_is_sharding)[0].mesh
    return all(c == 0 for c in mesh.coords.values()), mesh.size


def _gathered(tree, shardings) -> tuple:
    """(host copies of the full leaves, structure): each leaf gathered from
    the ranks' blocks (a collective) when ``shardings`` is given."""
    leaves, treedef = flatten(tree)
    if shardings is None:
        return [l if isinstance(l, np.ndarray) else _host_copy(l)
                for l in leaves], treedef
    shs = tree_leaves(shardings, is_leaf=_is_sharding)
    return [_host_copy(s.gather(l.detach()) if isinstance(l, torch.Tensor)
                       else l) for l, s in zip(leaves, shs)], treedef


def _barrier(size: int) -> None:
    if size > 1:
        import torch.distributed as dist
        dist.barrier()


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of a leaf that owns its memory (a CPU tensor's
    ``numpy()`` would share the tensor's)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(path: str, step: int, tree, metadata=None, shardings=None) -> str:
    """Write ``tree`` (this rank's blocks by ``shardings``, when given:
    gathered, written by rank 0, the others waiting at a barrier)."""
    np_leaves, treedef = _gathered(tree, shardings)
    lead, size = _lead(shardings)
    final = os.path.join(path, f"step_{step:08d}")
    if lead:
        _write(final, step, np_leaves, treedef, metadata)
    _barrier(size)
    return final


def _write(final, step, np_leaves, treedef, metadata):
    tmp = final + f".tmp.{os.getpid()}.{int(time.time()*1e6)}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": repr(treedef),
        "n_leaves": len(np_leaves),
        "shapes": [list(l.shape) for l in np_leaves],
        "dtypes": [str(l.dtype) for l in np_leaves],
        "metadata": metadata or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": l for i, l in enumerate(np_leaves)})
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(path: str):
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(path, d, "manifest.json")):
            try:
                steps.append(int(d.split("_")[1].split(".")[0]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore(path: str, step: int, like_tree, shardings=None):
    """Restore into the structure of ``like_tree``, each leaf with the
    dtype and device of its counterpart there.  With ``shardings`` (a tree
    of ``distributed.sharding.NamedSharding`` matching it) each leaf is
    this rank's block of the whole array, and ``like_tree`` holds blocks.
    A leaf count or a shape that differs raises ``ValueError``, as in the
    reference.  Returns (tree, manifest)."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves)} — structure changed?")
    shs = None if shardings is None else \
        tree_leaves(shardings, is_leaf=_is_sharding)
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, ref in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            want = tuple(arr.shape) if shs is None \
                else shs[i].local_shape(arr.shape)
            if want != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} (block "
                                 f"{want}) != {tuple(ref.shape)}")
            if shs is not None:
                arr = shs[i].local(arr)
            if isinstance(ref, torch.Tensor):
                out.append(torch.as_tensor(arr).to(device=ref.device,
                                                   dtype=ref.dtype))
            else:
                out.append(np.asarray(arr, dtype=np.asarray(ref).dtype))
    return unflatten(treedef, out), manifest


def retain(path: str, keep: int = 3):
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(path):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(path)
        if d.startswith("step_") and ".tmp" not in d)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot synchronously (device -> host copy), write on a worker
    thread.  ``wait`` returns once every queued save is on disk; a save
    that failed raises there or at the next ``save``.  On a ``mesh`` of
    several ranks every rank calls ``save`` with the state's
    ``shardings`` (the leaves are gathered), rank 0 writes, and ``wait``
    returns on every rank once rank 0's writes are done."""

    def __init__(self, path: str, keep: int = 3, mesh=None):
        self.path = path
        self.keep = keep
        self.size = 1 if mesh is None else mesh.size
        self.lead = mesh is None or all(c == 0
                                        for c in mesh.coords.values())
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, leaves_np, treedef, metadata = item
                save(self.path, step, unflatten(treedef, leaves_np),
                     metadata)
                retain(self.path, self.keep)
            except Exception as e:          # surfaced on next save/wait
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree, metadata=None, shardings=None):
        if self._err:
            raise self._err
        host, treedef = _gathered(tree, shardings)
        if self.lead:
            self._q.put((int(step), host, plain_structure(treedef),
                         metadata))

    def wait(self):
        self._q.join()
        _barrier(self.size)
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join(timeout=10)

