"""RawNet2: the raw-waveform model with a fixed sinc filter bank,
FMS-attended residual blocks and a GRU head, in eval and train mode.

Counterpart of the JAX package's ``models/rawnet.py``
(``RAWNET2_DEFAULT_ARGS``, ``sinc_filterbank``, ``sinc_conv_fft``,
``ResidualBlock``, ``FMSAttention``, ``GRULayer``, ``RawNet``) with the
reference's state_dict names (the JAX package's
``interop/torch_port.port_rawnet``):

- the sinc bank (``filts[0]`` mel-spaced band-pass filters of
  ``first_conv`` taps, one more when even; no parameters) correlates the
  waveform over its valid range, as one ``torch.fft`` rfft/irfft pair at
  the next power of two (the bank's conjugate spectrum computed in numpy
  float64 and kept as an f32 complex buffer) or, ``fft_frontend=False``,
  as the time-domain ``F.conv1d``; then |.|, max-pool 3 (floor mode),
  ``first_bn``, SELU;
- six residual blocks ``block{i}.0`` (``bn1`` and leaky ReLU 0.3 but for
  the first, ``conv1`` (k 3, over the block's raw input, as the reference
  computes it: ``bn1``'s output goes unused, while its statistics still
  move in train mode), ``bn2``, leaky ReLU 0.3, ``conv2`` (k 3), plus the
  input or its ``conv_downsample`` (k 1), max-pool 3), each followed by
  the filter-wise scaling ``fc_attention{i}.0``: g = sigmoid(dense(mean
  over time)), x g + g;
- ``bn_before_gru``, SELU, ``nb_gru_layer`` GRU layers (``gru``, a
  ``torch.nn.GRU``: torch's gate math with both bias vectors, gate order
  r|z|n, the JAX ``GRULayer``'s), the last step, ``fc1_gru`` and
  ``fc2_gru``.

The forward takes (B, L) waveforms and returns (pre-logits, log-
probabilities) in f32 (the JAX registry builds it without a compute
dtype). The layout inside is (B, C, T). Every BN takes autograd's VJP, as
the JAX ``batch_norm(train)`` takes autodiff. Weights start as flax
initializes the JAX model: lecun-normal kernels (convs, denses, the GRU's
input weights), the GRU's hidden weights orthogonal over the whole
(3H, H) matrix, zero biases.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import (
    BatchNorm, conv, dense, init_flax_like_, lecun_normal_)

RAWNET2_DEFAULT_ARGS = {
    # ASVspoof 2021 RawNet2 baseline hyperparameters.
    "nb_samp": 64600,
    "first_conv": 1024,
    "in_channels": 1,
    "filts": [20, [20, 20], [20, 128], [128, 128]],
    "blocks": [2, 4],
    "nb_fc_node": 1024,
    "gru_node": 1024,
    "nb_gru_layer": 3,
    "nb_classes": 2,
}


def sinc_filterbank(out_channels: int, kernel_size: int,
                    sample_rate: int = 16000) -> np.ndarray:
    """Mel-spaced band-pass sinc FIR bank, Hamming windowed, as (kernel, 1,
    out_channels) f32: the JAX ``sinc_filterbank``, bit for bit."""
    if kernel_size % 2 == 0:
        kernel_size += 1

    def to_mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def to_hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    nfft = 512
    f = int(sample_rate / 2) * np.linspace(0, 1, int(nfft / 2) + 1)
    fmel = to_mel(f)
    mel_points = np.linspace(fmel.min(), fmel.max(), out_channels + 1)
    hz_points = to_hz(mel_points)

    hsupp = np.arange(-(kernel_size - 1) / 2, (kernel_size - 1) / 2 + 1)
    window = np.hamming(kernel_size)
    bank = np.zeros((out_channels, kernel_size), dtype=np.float64)
    for i in range(out_channels):
        fmin, fmax = hz_points[i], hz_points[i + 1]
        h_high = (2 * fmax / sample_rate) * np.sinc(
            2 * fmax * hsupp / sample_rate)
        h_low = (2 * fmin / sample_rate) * np.sinc(
            2 * fmin * hsupp / sample_rate)
        bank[i] = window * (h_high - h_low)
    return bank.T[:, None, :].astype(np.float32)


def fft_size(length: int) -> int:
    """The correlation's FFT size for ``length`` samples: the next power of
    two at or above it (the circular wrap then misses the valid range)."""
    return 1 << (length - 1).bit_length()


def sinc_spectrum(bank: np.ndarray, n: int) -> torch.Tensor:
    """conj(rfft(bank, n)) of the (K, 1, C) bank as a (C, n // 2 + 1)
    complex64 tensor: computed in float64, each plane cast to f32, as the
    JAX ``sinc_conv_fft`` carries it."""
    spec = np.conj(np.fft.rfft(np.asarray(bank)[:, 0, :], n=n, axis=0))
    planes = [torch.from_numpy(np.ascontiguousarray(a.T.astype(np.float32)))
              for a in (spec.real, spec.imag)]
    return torch.complex(*planes)


def sinc_conv_fft(x: torch.Tensor, spec: torch.Tensor,
                  taps: int) -> torch.Tensor:
    """The valid cross-correlation of (B, L) waveforms with a bank of
    ``taps`` taps whose conjugate spectrum is ``spec`` (C, n // 2 + 1):
    (B, C, L - taps + 1), by one rfft/irfft pair of size n."""
    n = 2 * (spec.shape[-1] - 1)
    xs = torch.fft.rfft(x.float(), n=n, dim=-1)
    y = torch.fft.irfft(xs[:, None, :] * spec, n=n, dim=-1)
    return y[..., :x.shape[-1] - taps + 1]


class ResidualBlock(nn.Module):
    """The reference RawNet2's residual block (its model.py:709-762), over
    (B, C, T)."""

    def __init__(self, in_channels: int, out_channels: int,
                 first: bool = False):
        super().__init__()
        self.first = first
        if not first:
            self.bn1 = BatchNorm(in_channels)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1)
        self.bn2 = BatchNorm(out_channels)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=1)
        self.conv_downsample = (nn.Conv1d(in_channels, out_channels, 1)
                                if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.first and self.training:
            self.bn1(x)         # unused output; its statistics move
        out = F.leaky_relu(self.bn2(conv(self.conv1, x, None)), 0.3)
        out = conv(self.conv2, out, None)
        identity = (x if self.conv_downsample is None
                    else conv(self.conv_downsample, x, None))
        return F.max_pool1d(out + identity, 3)


class RawNet(nn.Module):
    """``d_args`` as ``RAWNET2_DEFAULT_ARGS`` (the default); built on
    ``device`` (the GPU unless the caller asks for the CPU), initialized
    from ``generator`` (a CPU generator; torch's global one when None)."""

    def __init__(self, d_args: Optional[dict] = None,
                 fft_frontend: bool = True,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        d = dict(RAWNET2_DEFAULT_ARGS if d_args is None else d_args)
        filts = [list(f) if isinstance(f, (list, tuple)) else f
                 for f in d["filts"]]
        self.d_args, self.fft_frontend = d, fft_frontend
        bank = sinc_filterbank(filts[0], d["first_conv"])
        self.taps = bank.shape[0]
        self._bank = bank
        self.register_buffer("sinc_bank", torch.from_numpy(
            np.ascontiguousarray(bank.transpose(2, 1, 0))), persistent=False)
        self.n_fft = fft_size(d["nb_samp"])
        self.register_buffer("sinc_spec", sinc_spectrum(bank, self.n_fft),
                             persistent=False)
        self.first_bn = BatchNorm(filts[0])
        block_filts = [filts[1], filts[1], filts[2],
                       [filts[2][1], filts[2][1]],
                       [filts[2][1], filts[2][1]],
                       [filts[2][1], filts[2][1]]]
        cin = filts[0]
        for i, bf in enumerate(block_filts):
            setattr(self, f"block{i}", nn.Sequential(
                ResidualBlock(cin, bf[1], first=(i == 0))))
            setattr(self, f"fc_attention{i}",
                    nn.Sequential(nn.Linear(bf[1], bf[1])))
            cin = bf[1]
        self.bn_before_gru = BatchNorm(cin)
        self.gru = nn.GRU(cin, d["gru_node"], d["nb_gru_layer"],
                          batch_first=True)
        self.fc1_gru = nn.Linear(d["gru_node"], d["nb_fc_node"])
        self.fc2_gru = nn.Linear(d["nb_fc_node"], d["nb_classes"])
        init_flax_like_(self, generator)
        for name, p in self.gru.named_parameters():
            if name.startswith("weight_ih"):
                lecun_normal_(p, generator)
            elif name.startswith("weight_hh"):
                with torch.no_grad():
                    nn.init.orthogonal_(p, generator=generator)
            else:
                nn.init.zeros_(p)
        self.to(dev)

    def sinc(self, x: torch.Tensor) -> torch.Tensor:
        """The sinc bank's valid correlation of (B, L) waveforms: (B, C,
        L - taps + 1)."""
        if not self.fft_frontend:
            return F.conv1d(x.float()[:, None, :], self.sinc_bank)
        n = fft_size(x.shape[-1])
        spec = (self.sinc_spec if n == self.n_fft
                else sinc_spectrum(self._bank, n).to(x.device))
        return sinc_conv_fft(x, spec, self.taps)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pre-logits, log-probabilities) of (B, L) (or (B, L, 1))
        waveforms, in f32."""
        disable_tf32()
        if x.dim() == 3:
            x = x[..., 0]
        x = F.max_pool1d(torch.abs(self.sinc(x)), 3)
        x = F.selu(self.first_bn(x))
        for i in range(6):
            x = getattr(self, f"block{i}")(x)
            g = torch.sigmoid(dense(getattr(self, f"fc_attention{i}")[0],
                                    x.mean(2), None))[:, :, None]
            x = x * g + g
        x = F.selu(self.bn_before_gru(x))
        x, _h = self.gru(x.transpose(1, 2))
        x = dense(self.fc2_gru, dense(self.fc1_gru, x[:, -1], None), None)
        return x, torch.log_softmax(x, dim=1)
