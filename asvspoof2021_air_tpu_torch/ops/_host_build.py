"""Build and load the port's host C++ libraries, without torch.

:func:`host_library` compiles the host sources under ``csrc/host/`` (the
FLAC decoder) with the host C++ compiler at first use into
``libasv_host_<hash>.so`` under :data:`BUILD_DIR` (:func:`build_dir`); it
needs no ``nvcc`` and runs on any machine. :func:`codec_library` compiles
the native codec library at the repo root (``native/augment/``) in place,
read-only, into a library of its own: ``csrc/host/flac_decode.cc`` is a
copy of ``native/augment/flac.cc``, so one library holding both would
define the FLAC symbols twice. This
module imports no torch, so the host-only paths (``data.augment_host``,
``cli.degrade``'s worker processes) load without it; ``ops/_build.py``
re-exports everything here beside the CUDA kernels' build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"


def build_dir(pkg: Path = _PKG) -> Path:
    """Where the libraries build: ``<package>/build`` where this process
    can make a file there (a checkout), else the per-user cache,
    ``$XDG_CACHE_HOME/asvspoof2021_air_tpu_torch`` (``~/.cache`` without
    it), as for an installed package in a directory that its user cannot
    write. The libraries' names carry their sources' digest in either
    place."""
    local = pkg / "build"
    try:
        local.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=local):
            return local
    except OSError:
        cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
        return Path(cache) / "asvspoof2021_air_tpu_torch"


BUILD_DIR = build_dir()
HOST_SRC = CSRC / "host"
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
# The native codec library at the repo root, compiled read-only: the
# sources of its Makefile's SRCS with the Makefile's code-generation flags
# (no -march=native, no -ffast-math), so that it computes bit for bit what
# the library the Makefile builds computes on the same machine.
NATIVE_DIR = _PKG.parent / "native"
CODEC_FLAGS = ["-O3", "-fPIC", "-std=c++17"]

I = ctypes.c_int
U8P = ctypes.POINTER(ctypes.c_uint8)
IP = ctypes.POINTER(ctypes.c_int)
# Host entry points of csrc/host/ -> (argument types, result type).
HOST_SIGNATURES = {
    "flac_stream_info": ([U8P, ctypes.c_size_t, IP, IP, IP], ctypes.c_long),
    "flac_decode": ([U8P, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32),
                     ctypes.c_size_t, IP, IP, IP], ctypes.c_long),
}

F = ctypes.c_float
FP = ctypes.POINTER(ctypes.c_float)
SZ = ctypes.c_size_t
L = ctypes.c_long
# Entry points of the native codec library -> (argument types, result
# type): the 37 declarations of native/augment/augment.h and the entry
# points its sources define beyond them that data/augment_host.py calls.
CODEC_SIGNATURES = {
    "g711_ulaw_roundtrip": ([FP, FP, SZ], None),
    "g711_alaw_roundtrip": ([FP, FP, SZ], None),
    "g711_ulaw_encode_sample": ([ctypes.c_int16], ctypes.c_uint8),
    "g711_ulaw_decode_sample": ([ctypes.c_uint8], ctypes.c_int16),
    "g711_alaw_encode_sample": ([ctypes.c_int16], ctypes.c_uint8),
    "g711_alaw_decode_sample": ([ctypes.c_uint8], ctypes.c_int16),
    "g726_roundtrip": ([FP, FP, SZ, I], None),
    "g726_encode": ([FP, SZ, I, U8P], L),
    "g726_decode": ([U8P, L, I, FP], L),
    "resample_sinc": ([FP, SZ, FP, I, I, I], SZ),
    "fft_convolve": ([FP, SZ, FP, SZ, FP], None),
    "rms_normalize": ([FP, FP, SZ, F], None),
    "gsmfr_encode": ([FP, SZ, U8P], L),
    "gsmfr_decode": ([U8P, L, FP], L),
    "gsmfr_roundtrip": ([FP, FP, SZ], None),
    "g722_encode": ([FP, SZ, U8P], L),
    "g722_decode": ([U8P, L, FP, I], L),
    "g722_roundtrip": ([FP, FP, SZ, I], None),
    "acelp_roundtrip": ([FP, FP, SZ, I, F], None),
    "acelp_channel": ([FP, FP, SZ, I, I, F], None),
    "amrnb_encode": ([FP, SZ, U8P], L),
    "amrnb_decode": ([U8P, SZ, FP, SZ], L),
    "amrnb_roundtrip": ([FP, FP, SZ], None),
    "amrnb_encode_mode": ([I, FP, SZ, U8P], L),
    "amrnb_decode_any": ([U8P, SZ, FP, SZ], L),
    "amrnb_roundtrip_mode": ([I, FP, FP, SZ], None),
    "amrnb_encode_dtx": ([I, FP, SZ, U8P], L),
    "amrnb_roundtrip_dtx": ([I, FP, FP, SZ], None),
    "amrwb_encode_mode": ([I, FP, SZ, U8P], L),
    "amrwb_encode_dtx_mode": ([I, FP, SZ, U8P], L),
    "amrwb_decode": ([U8P, SZ, FP, SZ], L),
    "amrwb_roundtrip_mode": ([I, FP, FP, SZ], None),
    "amrwb_roundtrip_dtx_mode": ([I, FP, FP, SZ], None),
    "mdct_codec_roundtrip": ([FP, FP, SZ, I, F, I], None),
    "telephony_channel": ([FP, FP, SZ, I, I], None),
    "mp3_encode": ([FP, SZ, I, I, U8P, SZ], L),
    "mp3_encode_bound": ([SZ, I, I], SZ),
    "mp3_decode": ([U8P, SZ, FP, SZ, IP], L),
    "mp3_roundtrip": ([FP, FP, SZ, I, F], None),
    "aac_encode": ([FP, SZ, I, I, U8P, SZ], L),
    "aac_encode_bound": ([SZ, I, I], SZ),
    "aac_decode": ([U8P, SZ, FP, SZ, IP], L),
    "aac_roundtrip": ([FP, FP, SZ, I, F], None),
    "g729_encode": ([FP, SZ, U8P], L),
    "g729_decode": ([U8P, SZ, FP, SZ], L),
    "g729_roundtrip": ([FP, FP, SZ], None),
    "flac_stream_info": ([U8P, SZ, IP, IP, IP], L),
    "flac_decode": ([U8P, SZ, ctypes.POINTER(ctypes.c_int32), SZ, IP, IP,
                     IP], L),
}

lock = threading.Lock()   # one build at a time in a process, CUDA's too
_host_lib = None
_codec_lib = None


def _digest(flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (set CXX or put c++ on "
                       "PATH)")


def host_library() -> ctypes.CDLL:
    """The host C++ library of ``csrc/host/*.cc``, built on first use with
    the host compiler into ``build/libasv_host_<hash>.so``."""
    global _host_lib
    with lock:
        if _host_lib is None:
            sources = sorted(HOST_SRC.glob("*.cc"))
            target = (BUILD_DIR
                      / f"libasv_host_{_digest(HOST_FLAGS, sources)}.so")
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                    tmp_lib = Path(tmp) / target.name
                    out = subprocess.run(
                        [_cxx(), *HOST_FLAGS, *map(str, sources), "-o",
                         str(tmp_lib)], capture_output=True, text=True)
                    if out.returncode != 0:
                        raise RuntimeError("host C++ build failed:\n"
                                           + out.stdout + out.stderr)
                    os.replace(tmp_lib, target)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _host_lib = lib
        return _host_lib


def codec_sources():
    """The native codec library's sources, in its Makefile's SRCS order,
    and its headers. They are read from a checkout's root, beside the
    package; an installed package has none."""
    if not (NATIVE_DIR / "Makefile").exists():
        raise RuntimeError(f"the native codec library's sources are not at "
                           f"{NATIVE_DIR}: cli.degrade runs from a checkout "
                           f"of the repository")
    text = (NATIVE_DIR / "Makefile").read_text()
    srcs = re.search(r"^SRCS\s*=\s*(.+)$", text, re.M).group(1).split()
    return ([NATIVE_DIR / s for s in srcs],
            sorted((NATIVE_DIR / "augment").glob("*.h")))


def codec_library() -> ctypes.CDLL:
    """The native codec library (``native/augment/*.cc``), compiled on
    first use with the host compiler into
    ``build/libasv_codecs_<hash>.so``: one compiler process per source,
    all started together, then one link. ``native/`` is only read."""
    global _codec_lib
    with lock:
        if _codec_lib is None:
            srcs, headers = codec_sources()
            target = (BUILD_DIR / "libasv_codecs_"
                      f"{_digest(CODEC_FLAGS, srcs + headers)}.so")
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                    objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
                    procs = [subprocess.Popen(
                        [_cxx(), *CODEC_FLAGS, "-c", str(src), "-o",
                         str(obj)], stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)
                        for src, obj in zip(srcs, objs)]
                    errors = []
                    for src, proc in zip(srcs, procs):
                        out, _ = proc.communicate()
                        if proc.returncode != 0:
                            errors.append(f"{src.name}:\n{out}")
                    if errors:
                        raise RuntimeError("codec library build failed:\n"
                                           + "\n".join(errors))
                    tmp_lib = Path(tmp) / target.name
                    out = subprocess.run(
                        [_cxx(), *CODEC_FLAGS, "-shared", *map(str, objs),
                         "-o", str(tmp_lib)], capture_output=True,
                        text=True)
                    if out.returncode != 0:
                        raise RuntimeError("codec library link failed:\n"
                                           + out.stdout + out.stderr)
                    os.replace(tmp_lib, target)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in CODEC_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _codec_lib = lib
        return _codec_lib
