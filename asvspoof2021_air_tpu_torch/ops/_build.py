"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``, and the objects are linked into one shared
library with a plain C interface that ``ctypes`` loads. The library lives
under ``asvspoof2021_air_tpu_torch/build/`` (git-ignored), named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
loads at once. Nothing is built at import time: the first wrapper that
launches a kernel on a CUDA tensor builds it.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

# Element-type codes of the C entry points (csrc/common.cuh ScalarCode).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P = ctypes.c_void_p
I = ctypes.c_int
# C entry point -> argument types; every entry returns cudaGetLastError(),
# but for those in RESTYPES.
SIGNATURES = {
    "lfcc_forward": [P, I, I, I, I, I, I, P, P, I, P, I, P, P, I, P, P],
    "res2_chain_forward": [P, P, P, P, P, P, I, I, I, I, I, I, P],
    "attn_pool_workspace": [I, I, I, I],
    "attn_pool_forward": [P, I, I, I, I, P, P, I, P, P, P, P, P, P, P, P, P,
                          I, P],
    "attn_pool_vjp_forward": [P, P, P, P, I, I, I, P, P, P, P, I, P],
    "attn_pool_vjp_backward": [P] * 10 + [I, I, I, P, P, P, P, I, P],
}
RESTYPES = {"attn_pool_workspace": ctypes.c_longlong}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build this process ran, if any


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = _nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / target.name
        subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
                        str(tmp_lib)], check=True, capture_output=True,
                       text=True)
        os.replace(tmp_lib, target)   # atomic: a concurrent loader sees all or none


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libasv_kernels_{_digest()}.so"
            if not target.exists():
                t0 = time.perf_counter()
                _compile(target)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream; raise on a CUDA
    error."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check_args(name: str, *pairs) -> None:
    """``pairs`` of (tensor, shape): every tensor contiguous, on the first
    tensor's CUDA device, and of its shape (None skips the shape check)."""
    dev = pairs[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: arguments must be CUDA tensors")
    for t, shape in pairs:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every argument must be a contiguous "
                             f"tensor on {dev}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
