"""Fused LFCC front-end: kernel B1 (``csrc/lfcc.cu``) and its plain version.

Counterpart of the JAX package's ``ops/lfcc_pallas.py`` (``PallasLFCC``,
whose two Pallas kernels ``_lfcc_lane128_kernel`` and ``_lfcc_kernel``
compute one function: frames -> windowed DFT -> power -> filterbank ->
log10 -> DCT). Pre-emphasis with its length mask, and the deltas, run in
plain torch around the kernel, as in JAX.

On a CUDA tensor :class:`CudaLFCC` launches the kernel, a real FFT of each
frame in registers and shared memory; on a CPU tensor it runs
:func:`lfcc_plain`, the same function as one product against the windowed
[cos | sin] matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.ops import _build, dsp
from asvspoof2021_air_tpu_torch.ops.lfcc import (
    LFCCConfig, append_deltas, cepstra, emphasize)

MAX_N_FFT = 512            # the kernel's largest FFT

launches = 0               # kernel launches since the last reset


def lfcc_plain(x: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
               dct: torch.Tensor, config: LFCCConfig) -> torch.Tensor:
    """(B, L) pre-emphasized f32 -> (B, T, n_filters): the kernel's function.
    ``cs`` is (win, 2 n) = [cos | sin] over n bins, ``fb`` (n, n_filters)."""
    frames = dsp.frame_signal(x, config.win_length, config.hop_length,
                              config.n_fft)
    return cepstra(frames, cs, fb, dct)[0]


def lfcc_kernel(x: torch.Tensor, window: torch.Tensor, twiddle: torch.Tensor,
                bands: torch.Tensor, weights: torch.Tensor, dct: torch.Tensor,
                config: LFCCConfig) -> torch.Tensor:
    """Launch B1 with the constants of :class:`CudaLFCC`: the analysis
    ``window`` (win,), ``twiddle`` (n_fft / 2, 2) = exp(-2 pi i k / n_fft),
    and the filterbank as each filter's nonzero bins ``bands``
    (n_filters, 2) int32 with their ``weights`` (width, n_filters)."""
    global launches
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("lfcc_kernel: x must be (B, L) float32")
    B, L = x.shape
    hop, win, n_fft = config.hop_length, config.win_length, config.n_fft
    T = dsp.num_frames(L, hop)
    nf = config.n_filters
    _build.check_args("lfcc_kernel", (x, None), (window, (win,)),
                      (twiddle, (n_fft // 2, 2)), (bands, (nf, 2)),
                      (weights, (weights.shape[0], nf)), (dct, (nf, nf)))
    if bands.dtype != torch.int32:
        raise ValueError("lfcc_kernel: bands must be int32")
    out = torch.empty((B, T, nf), device=x.device, dtype=torch.float32)
    _build.launch("lfcc_forward", x.device, x.data_ptr(), B, L, T, hop, win,
                  dsp.frame_start(win, n_fft), window.data_ptr(),
                  twiddle.data_ptr(), n_fft, weights.data_ptr(),
                  weights.shape[0], bands.data_ptr(), dct.data_ptr(), nf,
                  out.data_ptr())
    launches += 1
    return out


def fft_twiddles(n_fft: int) -> np.ndarray:
    """(n_fft / 2, 2) f32 table of exp(-2 pi i k / n_fft), computed in
    float64: the FFT's twiddles and its real-FFT post-twiddle."""
    phase = -2.0 * np.pi * np.arange(n_fft // 2, dtype=np.float64) / n_fft
    return np.stack([np.cos(phase), np.sin(phase)], axis=1).astype(np.float32)


def filter_bands(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank ``fb`` (n, n_filters) in compact form: ``bands``
    (n_filters, 2) int32, each filter's first nonzero bin and one past its
    last (0, 0 for an all-zero filter), and ``weights`` (width, n_filters),
    weights[i, f] = fb[bands[f, 0] + i, f] (zero past the filter's band)."""
    bands = np.zeros((fb.shape[1], 2), np.int32)
    for f in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, f])
        if nz.size:
            bands[f] = nz[0], nz[-1] + 1
    weights = np.zeros((max(1, int((bands[:, 1] - bands[:, 0]).max())),
                        fb.shape[1]), np.float32)
    for f, (lo, hi) in enumerate(bands):
        weights[:hi - lo, f] = fb[lo:hi, f]
    return bands, weights


class CudaLFCC:
    """Fused LFCC: (B, L) waveforms (+ lengths) -> (B, T, 3 n_filters).

    Same domain as the JAX ``PallasLFCC`` (win_length == 2 * hop_length,
    no energy coefficient), with n_fft a power of two, win_length <= n_fft
    <= 512, for the kernel's FFT."""

    def __init__(self, config: LFCCConfig = LFCCConfig(), device="cuda"):
        if config.win_length != 2 * config.hop_length:
            raise ValueError("CudaLFCC requires win_length == 2*hop_length")
        if config.with_energy:
            raise ValueError("with_energy unsupported in the fused kernel; "
                             "use the plain LFCC")
        n_fft = config.n_fft
        if n_fft > MAX_N_FFT or config.n_filters > 64:
            raise ValueError("CudaLFCC supports n_fft <= 512, n_filters <= 64")
        if n_fft < 4 or n_fft & (n_fft - 1) or config.win_length > n_fft:
            raise ValueError("CudaLFCC's FFT needs n_fft a power of two, "
                             "win_length <= n_fft")
        self.config = config
        self.device = resolve_device(device)
        C, S = dsp.windowed_dft_matrices(config.win_length, config.n_fft)
        fb = dsp.linear_filterbank(config.n_fft, config.sample_rate,
                                   config.n_filters)
        # The top filter's right edge sits on Nyquist, so the last bin's
        # weight is zero: drop it (as PallasLFCC does).
        n_eff = fb.shape[0] - 1 if np.all(fb[-1] == 0.0) else fb.shape[0]
        if n_eff > n_fft // 2:
            raise ValueError("CudaLFCC: the Nyquist filter weight must be 0")
        # lfcc_plain's [cos | sin] (win, 2 n_eff) and filterbank
        # (n_eff, n_filters).
        cs = np.concatenate([C[:, :n_eff], S[:, :n_eff]], axis=1)
        fb = np.ascontiguousarray(fb[:n_eff], dtype=np.float32)
        to = lambda a: torch.from_numpy(a).to(self.device)
        self.cs, self.fb = to(cs), to(fb)
        self.dct = to(dsp.dct_matrix(config.n_filters, "dct", norm="ortho"))
        # The kernel's constants: the window, the FFT's twiddles, and the
        # filterbank as each filter's nonzero bins and their weights.
        self.window = to(dsp.hamming_window(config.win_length, periodic=True))
        self.twiddle = to(fft_twiddles(n_fft))
        bands, weights = filter_bands(fb)
        self.bands, self.weights = to(bands), to(weights)

    def cepstra(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-emphasized (B, L) f32 -> (B, T, n_filters) via B1 on CUDA
        tensors and its plain version on CPU tensors."""
        if x.is_cuda:
            return lfcc_kernel(x, self.window, self.twiddle, self.bands,
                               self.weights, self.dct, self.config)
        return lfcc_plain(x, self.cs, self.fb, self.dct, self.config)

    def __call__(self, waveforms: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = emphasize(waveforms, self.config, lengths).contiguous()
        return append_deltas(self.cepstra(x), self.config, lengths)
