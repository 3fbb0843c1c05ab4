"""Constant-Q cepstral coefficient (CQCC) front-end, plain PyTorch.

Counterpart of the JAX package's ``ops/cqcc.py``: a multi-resolution
constant-Q transform (Q = 1/(2^(1/B)-1), a Hann-windowed complex kernel of
length Q sr / f_k per bin) computed octave by octave over a halfband
decimation pyramid, so each octave is one product against its kernel
matrices:

  stage s (rate sr/2^s, hop 160/2^s): frames (B, T, N) @ kernel (N, 96) ->
  one octave of CQ bins, time-aligned across stages because the hop scales
  with the rate.

Then the CQCC recipe: log power -> uniform resampling of the geometric
frequency axis -> DCT-II -> the first n_coef coefficients -> delta and
delta-delta. 7 octaves of 96 bins from 62.5 Hz, each octave one stage
earlier than the most decimation allows, 512 uniform bins, 30
coefficients, 90 dims out.

The decimation is ``F.conv1d`` at stride 2 (the JAX
``lax.conv_general_dilated``), the products are f32 with TF32 off on the
card, as JAX computes them. The numpy constants are built once per
instance, on its device; it computes in their type (a float64 copy of
them gives a float64 reference).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.ops import dsp


@dataclasses.dataclass(frozen=True)
class CQCCConfig:
    sample_rate: int = 16000
    fmin: float = 62.5            # 7 octaves up to 8 kHz
    n_octaves: int = 7
    bins_per_octave: int = 96
    hop_length: int = 160
    n_linear: int = 512           # uniform-resampled spectrum bins
    n_coef: int = 30              # kept cepstral coefficients
    with_delta: bool = True
    with_emphasis: bool = False
    max_stages: int = 6           # decimation stages (hop 160 -> 5 at s=5)

    @property
    def n_bins(self) -> int:
        return self.n_octaves * self.bins_per_octave

    @property
    def output_dim(self) -> int:
        return self.n_coef * (3 if self.with_delta else 1)


def cq_kernels(rel_freqs: np.ndarray, q: float, n_frame: int):
    """(n_frame, K) real/imag CQ kernel matrices for normalized frequencies
    ``rel_freqs`` (cycles/sample): per-bin Hann window of length ceil(q/nu)
    centered in the frame, unit-DC-gain normalized."""
    K = len(rel_freqs)
    re = np.zeros((n_frame, K), np.float64)
    im = np.zeros((n_frame, K), np.float64)
    for k, nu in enumerate(rel_freqs):
        n_k = min(int(np.ceil(q / nu)), n_frame)
        off = (n_frame - n_k) // 2
        n = np.arange(n_k)
        win = np.hanning(n_k)
        win = win / win.sum()
        re[off:off + n_k, k] = win * np.cos(2 * np.pi * nu * n)
        im[off:off + n_k, k] = win * np.sin(2 * np.pi * nu * n)
    return re.astype(np.float32), im.astype(np.float32)


def halfband_fir(taps: int = 127, beta: float = 12.0) -> np.ndarray:
    """Kaiser windowed-sinc lowpass at a quarter of the sampling rate (the
    halfband decimation prototype); beta 12 gives about 120 dB of stopband,
    so repeated decimation does not fold high-band energy into the low
    octaves."""
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(n / 2.0) / 2.0
    h *= np.kaiser(taps, beta)
    return (h / h.sum()).astype(np.float32)


def uniform_resample_matrix(cfg: CQCCConfig) -> np.ndarray:
    """(n_bins, n_linear) linear-interpolation matrix taking the
    geometrically spaced log-spectrum to a uniform frequency grid."""
    centers = cfg.fmin * 2.0 ** (np.arange(cfg.n_bins) / cfg.bins_per_octave)
    lin = np.linspace(centers[0], centers[-1], cfg.n_linear)
    M = np.zeros((cfg.n_bins, cfg.n_linear), np.float64)
    for j, f in enumerate(lin):
        i = np.searchsorted(centers, f)
        if i <= 0:
            M[0, j] = 1.0
        elif i >= cfg.n_bins:
            M[-1, j] = 1.0
        else:
            w = (f - centers[i - 1]) / (centers[i] - centers[i - 1])
            M[i - 1, j] = 1.0 - w
            M[i, j] = w
    return M.astype(np.float32)


class CQCC:
    """Batched CQCC extractor: (B, L) waveforms (+ lengths) -> (B, T,
    output_dim), T = 1 + L // hop."""

    def __init__(self, config: CQCCConfig = CQCCConfig(), device="cuda"):
        self.config = cfg = config
        self.device = resolve_device(device)
        disable_tf32()
        B = cfg.bins_per_octave
        q = 1.0 / (2.0 ** (1.0 / B) - 1.0)
        centers = cfg.fmin * 2.0 ** (np.arange(cfg.n_bins) / B)
        # Octave o (0 = top) runs at stage s = min(o - 1, max_s) (clamped
        # at 0), one stage before the most decimation, so its band sits in
        # [1/8, 1/4) of the stage's rate, below the halfband decimator's
        # transition band; max_s keeps hop >> s an integer.
        max_s = cfg.max_stages - 1
        while (cfg.hop_length >> max_s) << max_s != cfg.hop_length:
            max_s -= 1
        self.n_stages = max_s + 1
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self.oct_stage, self.kernels = [], []
        for o in range(cfg.n_octaves):
            s = min(max(o - 1, 0), max_s)
            lo = cfg.n_bins - (o + 1) * B
            nu = centers[lo:lo + B] / (cfg.sample_rate / (1 << s))
            n_frame = 1 << int(np.ceil(np.log2(q / nu.min() + 1)))
            re, im = cq_kernels(nu, q, n_frame)
            self.oct_stage.append(s)
            # the octave's [re | im] kernel matrix (n_frame, 2 B)
            self.kernels.append(to(np.concatenate([re, im], axis=1)))
        self.hb = to(halfband_fir())
        self.resample = to(uniform_resample_matrix(cfg))
        self.dct = to(dsp.dct_matrix(cfg.n_linear, "dct",
                                     norm="ortho")[:, :cfg.n_coef])

    @property
    def hop_length(self) -> int:
        return self.config.hop_length

    def frame_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return 1 + lengths // self.config.hop_length

    def decimate(self, x: torch.Tensor) -> torch.Tensor:
        """Halfband filter and every other sample: (B, L) -> (B, ceil(L/2))."""
        pad = self.hb.shape[0] // 2
        return F.conv1d(F.pad(x, (pad, pad))[:, None], self.hb[None, None],
                        stride=2)[:, 0]

    def log_cq(self, waveforms: torch.Tensor) -> torch.Tensor:
        """Log-power constant-Q transform: (B, L) -> (B, T, n_bins), bins
        ordered low to high frequency at fmin * 2^(k / bins_per_octave)."""
        cfg = self.config
        x = waveforms.to(self.hb.dtype)
        T = dsp.num_frames(x.shape[1], cfg.hop_length)
        pyramid = [x]
        for _s in range(1, self.n_stages):
            pyramid.append(self.decimate(pyramid[-1]))
        # frame t of stage s is centered at t (hop >> s) 2^s = t hop
        logs = []
        for s, cs in zip(self.oct_stage, self.kernels):
            n_frame = cs.shape[0]
            frames = dsp.frame_signal(pyramid[s], n_frame,
                                      cfg.hop_length >> s, n_frame)[:, :T]
            if frames.shape[1] < T:       # the decimation's rounding tail
                frames = F.pad(frames, (0, 0, 0, T - frames.shape[1]))
            z = frames @ cs
            n = cs.shape[1] // 2
            power = z[..., :n] * z[..., :n] + z[..., n:] * z[..., n:]
            logs.append(torch.log(power + dsp.FLOAT32_EPS))
        # octave o covers bins [n_bins - (o + 1) B, n_bins - o B)
        return torch.cat(logs[::-1], dim=-1)

    def __call__(self, waveforms: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        x = waveforms.to(self.hb.dtype)
        if lengths is not None:
            lengths = lengths.to(x.device)
        if cfg.with_emphasis:
            x = dsp.preemphasis(x)
            if lengths is not None:
                mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                        < lengths[:, None])
                x = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
        cqcc = (self.log_cq(x) @ self.resample) @ self.dct
        if cfg.with_delta:
            flen = None if lengths is None else self.frame_lengths(lengths)
            d1 = dsp.delta(cqcc, flen)
            d2 = dsp.delta(d1, flen)
            cqcc = torch.cat([cqcc, d1, d2], dim=-1)
        return cqcc

    def silence_frame(self) -> torch.Tensor:
        """The feature vector of a fully silent frame (the first frame of
        the CQCC of 3200 zero samples), for the 'silence' padding policy."""
        return self(torch.zeros((1, 3200), dtype=self.hb.dtype,
                                device=self.device))[0, 0]
