"""Fused LFCC front-end: kernel B1 (``csrc/lfcc.cu``) and its plain version.

Counterpart of the JAX package's ``ops/lfcc_pallas.py`` (``PallasLFCC``,
whose two Pallas kernels ``_lfcc_lane128_kernel`` and ``_lfcc_kernel``
compute one function: frames -> windowed DFT -> power -> filterbank ->
log10 -> DCT). Pre-emphasis with its length mask, and the deltas, run in
plain torch around the kernel, as in JAX.

On a CUDA tensor :class:`CudaLFCC` launches the kernel; on a CPU tensor it
runs :func:`lfcc_plain`, the same arithmetic in PyTorch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.ops import _build, dsp
from asvspoof2021_air_tpu_torch.ops.lfcc import (
    LFCCConfig, append_deltas, cepstra, emphasize)

KERNEL_COLS = 512          # the kernel's [cos | sin] width: n_fft <= 512

launches = 0               # kernel launches since the last reset


def lfcc_plain(x: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
               dct: torch.Tensor, config: LFCCConfig) -> torch.Tensor:
    """(B, L) pre-emphasized f32 -> (B, T, n_filters): the kernel's function.
    ``cs`` is (win, 2 n) = [cos | sin] over n bins, ``fb`` (n, n_filters)."""
    frames = dsp.frame_signal(x, config.win_length, config.hop_length,
                              config.n_fft)
    return cepstra(frames, cs, fb, dct)[0]


def lfcc_kernel(x: torch.Tensor, cs: torch.Tensor, fb: torch.Tensor,
                dct: torch.Tensor, config: LFCCConfig) -> torch.Tensor:
    """Launch B1 with the constants of :class:`CudaLFCC`."""
    global launches
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("lfcc_kernel: x must be (B, L) float32")
    B, L = x.shape
    hop, win = config.hop_length, config.win_length
    T = dsp.num_frames(L, hop)
    nf = config.n_filters
    _build.check_args("lfcc_kernel", (x, None), (cs, (win, KERNEL_COLS)),
                      (fb, (KERNEL_COLS // 2, nf)), (dct, (nf, nf)))
    out = torch.empty((B, T, nf), device=x.device, dtype=torch.float32)
    _build.launch("lfcc_forward", x.device, x.data_ptr(), B, L, T, hop, win,
                  dsp.frame_start(win, config.n_fft), cs.data_ptr(),
                  fb.data_ptr(), dct.data_ptr(), nf, out.data_ptr())
    launches += 1
    return out


class CudaLFCC:
    """Fused LFCC: (B, L) waveforms (+ lengths) -> (B, T, 3 n_filters).

    Same domain as the JAX ``PallasLFCC``: win_length == 2 * hop_length and
    no energy coefficient."""

    def __init__(self, config: LFCCConfig = LFCCConfig(), device="cuda"):
        if config.win_length != 2 * config.hop_length:
            raise ValueError("CudaLFCC requires win_length == 2*hop_length")
        if config.with_energy:
            raise ValueError("with_energy unsupported in the fused kernel; "
                             "use the plain LFCC")
        if config.n_fft > KERNEL_COLS or config.n_filters > 64:
            raise ValueError("CudaLFCC supports n_fft <= 512, n_filters <= 64")
        self.config = config
        self.device = resolve_device(device)
        C, S = dsp.windowed_dft_matrices(config.win_length, config.n_fft)
        fb = dsp.linear_filterbank(config.n_fft, config.sample_rate,
                                   config.n_filters)
        # The top filter's right edge sits on Nyquist, so the last bin's
        # weight is zero: drop it (as PallasLFCC does).
        n_eff = fb.shape[0] - 1 if np.all(fb[-1] == 0.0) else fb.shape[0]
        if 2 * n_eff > KERNEL_COLS:
            raise ValueError("CudaLFCC: the Nyquist filter weight must be 0")
        # [cos | sin] as (win, 512) and the filterbank as (256, n_filters),
        # the kernel's fixed widths; bins past n_eff are zero in both.
        half = KERNEL_COLS // 2
        cs = np.zeros((config.win_length, KERNEL_COLS), np.float32)
        cs[:, :n_eff] = C[:, :n_eff]
        cs[:, half:half + n_eff] = S[:, :n_eff]
        fbp = np.zeros((half, config.n_filters), np.float32)
        fbp[:n_eff] = fb[:n_eff]
        to = lambda a: torch.from_numpy(a).to(self.device)
        self.cs, self.fb = to(cs), to(fbp)
        self.dct = to(dsp.dct_matrix(config.n_filters, "dct", norm="ortho"))

    def cepstra(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-emphasized (B, L) f32 -> (B, T, n_filters) via B1 on CUDA
        tensors and its plain version on CPU tensors."""
        fn = lfcc_kernel if x.is_cuda else lfcc_plain
        return fn(x, self.cs, self.fb, self.dct, self.config)

    def __call__(self, waveforms: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = emphasize(waveforms, self.config, lengths).contiguous()
        return append_deltas(self.cepstra(x), self.config, lengths)
