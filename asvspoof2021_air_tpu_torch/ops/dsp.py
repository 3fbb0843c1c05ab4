"""DSP primitives for the front-ends: constant builders in numpy and
framing, pre-emphasis and deltas on torch tensors; the companding and
quantization helpers (mu-law, A-law, integer codes) of the channel
augmenter.

The numpy builders are the port's own copy of the JAX package's
``ops/dsp.py`` constant builders (the tests hold them equal); every
transform is a precomputed matrix so the hot path is matrix products.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

FLOAT32_EPS = float(np.finfo(np.float32).eps)


def hamming_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hamming window; periodic=True matches torch.hamming_window's default."""
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * k / denom)).astype(np.float32)


def dct_matrix(n: int, kind: str = "dct", norm: str | None = None) -> np.ndarray:
    """Matrix M such that ``x @ M`` applies the requested DCT along the last
    axis. kinds: 'dct1'/'idct1' (type I and inverse), 'dct'/'idct' (type II
    and its inverse). norm=None or 'ortho' (scipy.fft.dct conventions)."""
    k = np.arange(n, dtype=np.float64)
    m = k[:, None]
    if kind == "dct1":
        M = 2.0 * np.cos(np.pi * m * k[None, :] / (n - 1))
        M[0, :] = 1.0
        M[-1, :] = (-1.0) ** k
        return M.astype(np.float32)
    if kind == "idct1":
        return (dct_matrix(n, "dct1") / (2.0 * (n - 1))).astype(np.float32)
    if kind == "dct":
        M = 2.0 * np.cos(np.pi * (2.0 * m + 1.0) * k[None, :] / (2.0 * n))
        if norm == "ortho":
            M[:, 0] /= np.sqrt(n) * 2.0
            M[:, 1:] /= np.sqrt(n / 2.0) * 2.0
        return M.astype(np.float32)
    if kind == "idct":
        fwd = dct_matrix(n, "dct", norm=norm).astype(np.float64)
        return np.linalg.inv(fwd).astype(np.float32)
    raise ValueError(f"unknown DCT kind: {kind}")


def trimf(x: np.ndarray, a: float, b: float, c: float) -> np.ndarray:
    """Triangular membership function (Matlab trimf semantics)."""
    if not (a <= b <= c):
        raise ValueError("trimf requires a <= b <= c")
    x = np.asarray(x, dtype=np.float64)
    y = np.zeros_like(x)
    if a < b:
        idx = (a < x) & (x < b)
        y[idx] = (x[idx] - a) / (b - a)
    if b < c:
        idx = (b < x) & (x < c)
        y[idx] = (c - x[idx]) / (c - b)
    y[x == b] = 1.0
    return y


def linear_filterbank(n_fft: int, sr: int, n_filters: int) -> np.ndarray:
    """(n_fft//2+1, n_filters) bank of triangular filters on a linear
    frequency scale."""
    f = (sr / 2.0) * np.linspace(0.0, 1.0, n_fft // 2 + 1)
    bands = np.linspace(f.min(), f.max(), n_filters + 2)
    fb = np.zeros((n_fft // 2 + 1, n_filters), dtype=np.float64)
    for i in range(n_filters):
        fb[:, i] = trimf(f, bands[i], bands[i + 1], bands[i + 2])
    return fb.astype(np.float32)


def mel_filterbank(n_fft: int, sr: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False) -> np.ndarray:
    """(n_fft//2+1, n_mels) Slaney-normalized mel filterbank (librosa
    conventions), backing the Melspec feature; the JAX package's
    ``ops/dsp.py`` ``mel_filterbank``."""
    fmax = sr / 2.0 if fmax is None else fmax

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        if htk:
            return 2595.0 * np.log10(1.0 + f / 700.0)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        logstep = np.log(6.4) / 27.0
        log_t = f >= min_log_hz
        mels = np.where(log_t, min_log_hz / f_sp
                        + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        mels)
        return mels

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        if htk:
            return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
        f_sp = 200.0 / 3
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                    n_mels + 2))
    fb = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.T.astype(np.float32)


def windowed_dft_matrices(
    win_length: int, n_fft: int, window: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices of shape (win_length, n_fft//2+1) with the
    analysis window, zero-padded to n_fft and centered, folded in: the STFT
    power spectrum is ``(frames @ C)**2 + (frames @ S)**2``."""
    if window is None:
        window = hamming_window(win_length, periodic=True)
    window = np.asarray(window, dtype=np.float64)
    n_bins = n_fft // 2 + 1
    offset = (n_fft - win_length) // 2
    m = np.arange(win_length, dtype=np.float64)[:, None] + offset
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * m * k / n_fft
    C = (window[:, None] * np.cos(phase)).astype(np.float32)
    S = (-window[:, None] * np.sin(phase)).astype(np.float32)
    return C, S


def num_frames(length: int, hop: int) -> int:
    """Frame count of a center-padded STFT: 1 + floor(length / hop)."""
    return 1 + length // hop


def frame_start(win_length: int, n_fft: int) -> int:
    """Signal index of frame 0's first sample (negative: centered padding)."""
    return (n_fft - win_length) // 2 - n_fft // 2


def frame_signal(x: torch.Tensor, win_length: int, hop: int,
                 n_fft: int) -> torch.Tensor:
    """Center-padded analysis frames: (B, L) -> (B, T, win_length), as
    torch.stft(center=True, pad_mode='constant') frames them with the window
    centered in the n_fft frame."""
    B, L = x.shape
    T = num_frames(L, hop)
    start = frame_start(win_length, n_fft)
    pad_left = -start
    pad_right = max(0, (T - 1) * hop + start + win_length - L)
    xp = torch.nn.functional.pad(x, (pad_left, pad_right))
    return xp.unfold(1, win_length, hop)[:, :T]


def preemphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - coef * x[n-1], y[0] = x[0]."""
    return torch.cat([x[..., :1], x[..., 1:] - coef * x[..., :-1]], dim=-1)


def delta(x: torch.Tensor, lengths: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """First-order delta along frames: out[t] = x[t+1] - x[t-1] with
    replicate padding. x: (B, T, D). With ``lengths`` (B,) frame counts the
    replicate boundary follows each utterance's true length."""
    B, T, D = x.shape
    prv_x = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    nxt_x = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    if lengths is not None:
        last = (lengths - 1).long().to(x.device)
        x_last = x[torch.arange(B, device=x.device), last]       # (B, D)
        t = torch.arange(T, device=x.device)
        keep = t[None, :, None] < last[:, None, None]
        nxt_x = torch.where(keep, nxt_x, x_last[:, None, :])
    return nxt_x - prv_x


# ---------------------------------------------------------------------------
# Companding and quantization utilities (the JAX package's ops/dsp.py:239-289)
# ---------------------------------------------------------------------------

def label_2_float(x, bits: int):
    """Integer code -> float in [-1, 1]."""
    return 2.0 * x / (2.0 ** bits - 1.0) - 1.0


def float_2_label(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Float wav -> code in [0, 2^bits - 1] (a float), peak-normalizing the
    whole tensor if |x| > 1 anywhere."""
    peak = torch.max(torch.abs(x))
    x = torch.where(peak > 1.0, x / peak, x)
    x = (x + 1.0) * (2.0 ** bits - 1.0) / 2.0
    return torch.clamp(x, 0.0, 2.0 ** bits - 1.0)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as JAX computes its constants."""
    return float(np.float32(v))


def mulaw_encode(x: torch.Tensor, quantization_channels: int,
                 scale_to_int: bool = True) -> torch.Tensor:
    """mu-law companding of float waveforms in (-1, 1); with
    ``scale_to_int`` the int32 code (truncated, as an int cast does)."""
    mu = float(quantization_channels - 1)
    x = x.float()
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / _f32(np.log1p(mu))
    if scale_to_int:
        x_mu = ((x_mu + 1) / 2 * mu + 0.5).to(torch.int32)
    return x_mu


def mulaw_decode(x_mu: torch.Tensor, quantization_channels: int,
                 input_int: bool = True) -> torch.Tensor:
    """Inverse mu-law."""
    mu = float(quantization_channels - 1)
    x_mu = x_mu.float()
    x = (x_mu / mu) * 2 - 1.0 if input_int else x_mu
    return torch.sign(x) * (torch.exp(torch.abs(x) * _f32(np.log1p(mu)))
                            - 1.0) / mu


def alaw_encode(x: torch.Tensor, A: float = 87.6) -> torch.Tensor:
    """A-law companding (the G.711 A-law characteristic), float in/out."""
    ax = torch.abs(x)
    inv_log = _f32(1.0 / (1.0 + _f32(np.log(np.float32(A)))))
    y = torch.where(ax < 1.0 / A, A * ax * inv_log,
                    (1.0 + torch.log(A * torch.clamp(ax, min=1.0 / A)))
                    * inv_log)
    return torch.sign(x) * y


def alaw_decode(y: torch.Tensor, A: float = 87.6) -> torch.Tensor:
    """Inverse A-law companding, float in/out."""
    ay = torch.abs(y)
    log1pA = _f32(1.0 + _f32(np.log(np.float32(A))))
    x = torch.where(ay < 1.0 / log1pA, ay * log1pA / A,
                    torch.exp(ay * log1pA - 1.0) / A)
    return torch.sign(y) * x
