"""LFCC, STFT and Melspec front-ends in plain PyTorch.

LFCC, a matrix-product formulation: pre-emphasis -> framing -> windowed
DFT (one product against the [cos | sin] matrix) -> power -> linear
filterbank -> log10 -> ortho DCT-II -> delta and delta-delta, over
batched padded waveforms with per-utterance lengths. Canonical
configuration: LFCC(fl=320, fs=160, fn=512, sr=16000, filter_num=20).
STFT: the same framing's power spectrum. Melspec: the librosa mel power
spectrogram, both through ``torch.fft.rfft``.
Counterparts of the JAX package's ``ops/lfcc.py`` ``LFCC``, ``STFT`` and
``Melspec``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.ops import dsp

INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


@dataclasses.dataclass(frozen=True)
class LFCCConfig:
    win_length: int = 320        # 'fl' in the reference
    hop_length: int = 160        # 'fs'
    n_fft: int = 512             # 'fn'
    sample_rate: int = 16000     # 'sr'
    n_filters: int = 20          # 'filter_num'
    with_energy: bool = False
    with_emphasis: bool = True
    with_delta: bool = True
    preemph_coef: float = 0.97


def emphasize(waveforms: torch.Tensor, config: LFCCConfig,
              lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 pre-emphasis; with ``lengths`` the sample after each utterance's
    end (which pre-emphasis would set to -coef*x[len-1]) is masked back to
    zero, since the last frame covers it."""
    x = waveforms.float()
    if not config.with_emphasis:
        return x
    x = dsp.preemphasis(x, config.preemph_coef)
    if lengths is not None:
        mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                < lengths.to(x.device)[:, None])
        x = torch.where(mask, x, torch.zeros((), device=x.device))
    return x


def append_deltas(lfcc: torch.Tensor, config: LFCCConfig,
                  lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[c, delta c, delta-delta c] along features, replicate boundary at
    each utterance's true frame count."""
    if not config.with_delta:
        return lfcc
    flen = None if lengths is None else 1 + lengths // config.hop_length
    d1 = dsp.delta(lfcc, flen)
    d2 = dsp.delta(d1, flen)
    return torch.cat([lfcc, d1, d2], dim=-1)


def cepstra(frames: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
            dct: torch.Tensor):
    """Framed f32 signal (..., win) -> (cepstra (..., n_filters), power
    (..., n)): the windowed DFT as one product against ``cs`` = [cos | sin]
    over n bins, re^2 + im^2, the filterbank ``fb`` (n, n_filters), log10
    and the DCT. The plain LFCC and kernel B1's plain version both run it,
    each with its own constants."""
    z = frames @ cs
    n = cs.shape[1] // 2
    power = z[..., :n] ** 2 + z[..., n:] ** 2
    return (torch.log(power @ fb + dsp.FLOAT32_EPS) * INV_LN10) @ dct, power


class LFCC:
    """Batched LFCC extractor: (B, L) float waveforms -> (B, T, D) with
    T = 1 + L // hop."""

    def __init__(self, config: LFCCConfig = LFCCConfig(), device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        C, S = dsp.windowed_dft_matrices(config.win_length, config.n_fft)
        fb = dsp.linear_filterbank(config.n_fft, config.sample_rate,
                                   config.n_filters)
        dct = dsp.dct_matrix(config.n_filters, "dct", norm="ortho")
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self._cs = as_t(np.concatenate([C, S], axis=1))
        self._fb, self._dct = as_t(fb), as_t(dct)

    def __call__(self, waveforms: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        x = emphasize(waveforms, cfg, lengths)
        frames = dsp.frame_signal(x, cfg.win_length, cfg.hop_length, cfg.n_fft)
        lfcc, power = cepstra(frames, self._cs, self._fb, self._dct)
        if cfg.with_energy:
            energy = torch.log10(power.sum(-1) / cfg.n_fft + dsp.FLOAT32_EPS)
            lfcc = torch.cat([energy[..., None], lfcc[..., 1:]], dim=-1)
        return append_deltas(lfcc, cfg, lengths)

    def silence_frame(self) -> torch.Tensor:
        """Feature vector of a fully silent frame (first frame of the LFCC
        of 3200 zero samples), used by the 'silence' padding policy."""
        wav = torch.zeros((1, 3200), device=self.device)
        return self(wav)[0, 0]


class STFT:
    """Power spectrogram: (B, L) waveforms -> (B, T, n_fft//2+1), T = 1 +
    L // hop, with pre-emphasis (unmasked: the JAX ``STFT`` takes no
    lengths) and the LFCC's framing and periodic Hamming window. The power
    is ``torch.fft.rfft``'s of each windowed frame (cuFFT on the card): the
    window's offset inside the n_fft frame is a phase, so the power equals
    the JAX package's (frames C)^2 + (frames S)^2, and lies closer to its
    float64 value than that f32 product does. It computes in its window's
    type (f32; float64 with the window cast, as a reference)."""

    def __init__(self, config: LFCCConfig = LFCCConfig(), device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.window = torch.from_numpy(
            dsp.hamming_window(config.win_length)).to(self.device)

    @property
    def hop_length(self) -> int:
        return self.config.hop_length

    def __call__(self, waveforms: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = waveforms.to(self.window.dtype)
        if cfg.with_emphasis:
            x = dsp.preemphasis(x, cfg.preemph_coef)
        frames = dsp.frame_signal(x, cfg.win_length, cfg.hop_length,
                                  cfg.n_fft)
        z = torch.fft.rfft(frames * self.window, n=cfg.n_fft)
        return z.real ** 2 + z.imag ** 2


class Melspec:
    """Mel power spectrogram, librosa conventions (n_fft 512, hop 128,
    centered reflect padding, periodic Hann window, Slaney mel filters):
    (B, L) waveforms -> (B, n_mels, T), T = 1 + L // hop. The power
    spectrum is :class:`STFT`'s ``rfft``; the filterbank a product (TF32
    off on the card). It computes in its window's and filterbank's type."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 512,
                 hop_length: int = 128, n_mels: int = 128, device="cuda"):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.device = resolve_device(device)
        disable_tf32()
        to = lambda a: torch.from_numpy(a).to(self.device)
        self.window = to(np.hanning(n_fft + 1)[:-1].astype(np.float32))
        self.fb = to(dsp.mel_filterbank(n_fft, sample_rate, n_mels))

    def __call__(self, waveforms: torch.Tensor) -> torch.Tensor:
        pad = self.n_fft // 2
        x = torch.nn.functional.pad(waveforms.to(self.window.dtype)[:, None],
                                    (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(1, self.n_fft, self.hop_length)
        z = torch.fft.rfft(frames * self.window, n=self.n_fft)
        return ((z.real ** 2 + z.imag ** 2) @ self.fb).transpose(1, 2)
