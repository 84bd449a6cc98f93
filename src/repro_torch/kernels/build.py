"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each ``*.cu`` source has a plain C interface.  ``nvcc`` compiles every
source to an object file for ``sm_90a`` (all compilations started at once),
links them into one shared library, and ``ctypes`` loads it.  The library
lands in ``build/repro_torch/<hash>/`` at the root of the checkout (listed
in ``.gitignore``), keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "librepro_kernels.so"

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# C signatures: every pointer and the stream as c_void_p, every size int64
SIGNATURES = {
    "repro_xtv_f32": [_P, _P, _P, _P, _I64, _I64, _P],
    "repro_screen_norms_f32": [_P] * 5 + [_I64] * 4 + [_P],
    "repro_sgl_prox_f32": [_P] * 7 + [_I64, _I64, _I64, _P],
    "repro_screen_norms_folds_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "repro_dpc_screen_folds_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
}

_lock = threading.Lock()
_lib = None
last_build_seconds = None   # wall time of this process's build, if any


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    objs = [str(out_dir / (s.stem + ".o")) for s in sources()]
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")


def library_path() -> Path:
    """Path of the built library, building it if it is missing."""
    global last_build_seconds
    target = BUILD_ROOT / source_hash() / LIB_NAME
    if target.exists():
        return target
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        _compile(tmp)
        target.parent.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / LIB_NAME, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    return target


def load():
    """The loaded kernel library (built at first use), with its C
    signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            # how many row chunks xtv cuts N into (sizes its scratch)
            lib.repro_xtv_chunks.argtypes = [_I64, _I64]
            lib.repro_xtv_chunks.restype = ctypes.c_int64
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(t, name: str, dtype, shape) -> None:
    """Refuse what a kernel does not take: another dtype, a tensor off the
    card, another shape, a non-contiguous layout."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, not {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"not {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
