"""Audio file IO with the standard library and numpy: WAV (PCM 8/16/24/32
bit) and FLAC natively, other formats through the optional ``soundfile``
package.

The port's own copy of the JAX package's ``data/audio_io.py``. FLAC is
decoded by the port's copy of the JAX package's native decoder
(``csrc/host/flac_decode.cc``), a host C++ library that
``ops/_host_build.host_library`` builds with the host compiler at first
use.
"""

from __future__ import annotations

import ctypes
import wave
from typing import Optional, Tuple

import numpy as np

try:  # optional
    import soundfile as _sf
except ImportError:  # pragma: no cover
    _sf = None


def read_wav(path: str, target_sr: Optional[int] = 16000
             ) -> Tuple[np.ndarray, int]:
    """Read a WAV file to mono float32 in [-1, 1]; resamples with a linear
    interpolator only if target_sr differs."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")

    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)

    if target_sr is not None and sr != target_sr:
        data = resample_linear(data, sr, target_sr)
        sr = target_sr
    return data, sr


def write_wav(path: str, data: np.ndarray, sr: int = 16000) -> None:
    """Write mono float32 [-1, 1] to 16-bit PCM WAV."""
    data = np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0)
    pcm = np.round(data * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample_linear(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear-interpolation resampler."""
    n_out = int(round(len(data) * target_sr / sr))
    x_old = np.arange(len(data), dtype=np.float64)
    x_new = np.linspace(0, len(data) - 1, n_out)
    return np.interp(x_new, x_old, data).astype(np.float32)


def flac_decode(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream: (samples (n, channels) int32 at the stream's
    bit depth, sample_rate, bits_per_sample); ValueError on malformed
    input."""
    from asvspoof2021_air_tpu_torch.ops._host_build import host_library

    lib = host_library()
    buf = np.frombuffer(data, dtype=np.uint8)
    sr, nch, bps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    data_ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    # Size the output from STREAMINFO's total-samples field; 0 is the
    # spec's "unknown": then grow the buffer until the stream fits.
    total = lib.flac_stream_info(data_ptr, buf.size, ctypes.byref(sr),
                                 ctypes.byref(nch), ctypes.byref(bps))
    if total < 0:
        raise ValueError("malformed FLAC stream")
    channels = max(nch.value, 1)
    # Bound the header's 36-bit total so a corrupt header cannot force an
    # absurd allocation; past the bound the total is treated as unknown.
    cap = min(max(len(data) * 1024, 1 << 16), 1 << 28)
    trusted = 0 < total <= cap
    max_samples = total if trusted else max(len(data) * 4, 1 << 16)
    while True:
        out = np.empty(max_samples * channels, np.int32)
        n = lib.flac_decode(
            data_ptr, buf.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_samples,
            ctypes.byref(sr), ctypes.byref(nch), ctypes.byref(bps))
        if n < 0:
            raise ValueError("malformed FLAC stream")
        if n < max_samples or trusted:
            break
        max_samples *= 4
    samples = out[: n * nch.value].reshape(n, nch.value).copy()
    return samples, sr.value, bps.value


def read_flac(path: str, target_sr: Optional[int] = 16000
              ) -> Tuple[np.ndarray, int]:
    """Read a FLAC file to mono float32: the channels' mean over
    2^(bits - 1); resamples only if target_sr differs."""
    with open(path, "rb") as f:
        data = f.read()
    samples, sr, bps = flac_decode(data)
    scale = float(1 << (bps - 1))
    mono = samples.astype(np.float32).mean(axis=1) / scale
    if target_sr is not None and sr != target_sr:
        mono = resample_linear(mono, sr, target_sr)
        sr = target_sr
    return mono, sr


def load_audio(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """Load an audio file to mono float32 at target_sr: WAV and FLAC
    natively, any other format through soundfile when it is installed (and
    a FLAC file the native decoder refuses, then too)."""
    if path.lower().endswith(".wav"):
        return read_wav(path, target_sr)
    if path.lower().endswith(".flac"):
        try:
            return read_flac(path, target_sr)
        except (ValueError, OSError):
            if _sf is None:
                raise
    if _sf is not None:
        data, sr = _sf.read(path, dtype="float32")
        if data.ndim > 1:
            data = data.mean(axis=1)
        if sr != target_sr:
            data = resample_linear(data, sr, target_sr)
            sr = target_sr
        return data, sr
    raise RuntimeError(
        f"cannot load {path}: WAV and FLAC are read natively; other formats "
        "need the optional soundfile package")
