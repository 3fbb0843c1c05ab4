"""On-device front-ends: the channel augmenter (optional), LFCC (or CQCC)
with per-utterance lengths, then the reference's padding policy to
``feat_len`` frames (:class:`OnDeviceFrontend`); or, for the raw-waveform
RawNet2, the augmenter and the waveforms repeat-tiled to a fixed sample
count (:class:`WaveformFrontend`).

Counterpart of the JAX package's ``train/frontend.py`` ``OnDeviceFrontend``
and ``WaveformFrontend`` with the call form ``fe(batch, rng, params)`` of
the train step:

- with an ``augmenter`` (``ops/augment.ChannelAugmenter``) every
  utterance draws a channel before LFCC, over the whole (B, L_max)
  buffer, as in JAX; ``rng`` is the augmenter's draws (a dict from
  ``ChannelAugmenter.draw``) or a ``torch.Generator`` to draw them from,
  and ``params`` its tables (:attr:`params`); without one the call is
  deterministic and ``rng`` is not read;
- 'repeat':  frame t of a short utterance reads frame t mod T_valid;
- 'zero':    frames at and past T_valid are zeroed;
- 'silence': the features of silence are prepended and the valid frames
  shifted right, so output frame t reads valid frame t - (feat_len -
  T_valid).

Evaluation runs clean: :meth:`eval_view` drops the augmenter. LFCC runs
through kernel B1 (``ops/lfcc_cuda.py``) on the GPU; ``feature="CQCC"``
runs ``ops/cqcc.CQCC`` (plain PyTorch, 90 dims), as the JAX front-end
does; it refuses any other feature (ValueError), as JAX does.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.ops.cqcc import CQCC
from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC, LFCCConfig
from asvspoof2021_air_tpu_torch.ops.lfcc_cuda import CudaLFCC
from asvspoof2021_air_tpu_torch.utils import profiling


class OnDeviceFrontend:
    """fn({"wave": (B, L), "length": (B,)}, rng=None, params=None) ->
    (B, feat_len, D) features on ``device``."""

    def __init__(self, feat_len: int = 750, padding: str = "repeat",
                 config: LFCCConfig = LFCCConfig(), augmenter=None,
                 apply_ir: bool = False, device="cuda",
                 feature: str = "LFCC"):
        if padding not in ("repeat", "zero", "silence"):
            raise ValueError("padding should be zero, repeat, or silence")
        if feature not in ("LFCC", "CQCC"):
            raise ValueError(f"on-the-fly front-end supports LFCC/CQCC, got "
                             f"{feature}")
        self.feat_len = feat_len
        self.padding = padding
        self.augmenter = augmenter
        self.apply_ir = apply_ir
        self.device = resolve_device(device)
        self._silence_vec = None
        if feature == "CQCC":
            self.extractor = CQCC(device=self.device)
            self.hop = self.extractor.hop_length
            if padding == "silence":
                self._silence_vec = self.extractor.silence_frame()
            return
        self.extractor = CudaLFCC(config, device=self.device)
        self.hop = config.hop_length
        if padding == "silence":
            self._silence_vec = LFCC(config, device="cpu").silence_frame().to(
                self.device)

    def min_samples(self) -> int:
        """Waveform buffer length that yields >= feat_len frames."""
        return (self.feat_len - 1) * self.hop

    @property
    def params(self):
        """The augmenter's tables (None without an augmenter)."""
        return None if self.augmenter is None else self.augmenter.tables

    def eval_view(self) -> "OnDeviceFrontend":
        """Augmenter-free copy sharing the extractor, for the eval step."""
        view = copy.copy(self)
        view.augmenter = None
        view.apply_ir = False
        return view

    def __call__(self, batch: Dict[str, torch.Tensor], rng=None,
                 params=None) -> torch.Tensor:
        with profiling.span("asv.frontend"):
            return self._features(batch, rng, params)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the front end's device; the bytes copied from the host
        count under ``h2d_bytes``."""
        if t.device.type == "cpu" and self.device.type != "cpu":
            profiling.count("h2d_bytes", t.numel() * t.element_size())
        return t.to(self.device)

    def _features(self, batch: Dict[str, torch.Tensor], rng,
                  params) -> torch.Tensor:
        wave, lengths = batch["wave"], batch.get("length")
        if lengths is None:
            lengths = torch.full((wave.shape[0],), wave.shape[1])
        with profiling.span("asv.frontend.copy"):
            wave = self._to_device(wave)
            lengths = self._to_device(lengths).long()
        if self.augmenter is not None:
            if rng is None:
                raise ValueError("the channel augmenter needs rng: its draws "
                                 "or a torch.Generator")
            wave, _fam, _ir = self.augmenter(wave, rng, self.apply_ir,
                                             params)

        feats = self.extractor(wave, lengths)             # (B, T_max, D)
        B, T_max, D = feats.shape
        t_valid = torch.clamp(1 + lengths // self.hop, min=1)
        if T_max < self.feat_len:
            feats = torch.nn.functional.pad(
                feats, (0, 0, 0, self.feat_len - T_max))
            T_max = self.feat_len
        t = torch.arange(self.feat_len, device=self.device)
        rows = torch.arange(B, device=self.device)[:, None]

        if self.padding == "repeat":
            return feats[rows, t[None, :] % t_valid[:, None]]
        if self.padding == "zero":
            out = feats[:, :self.feat_len]
            return out * (t[None, :] < t_valid[:, None])[..., None].to(out.dtype)
        pad = self.feat_len - torch.clamp(t_valid, max=self.feat_len)
        src = torch.clamp(t[None, :] - pad[:, None], 0, T_max - 1)
        out = feats[rows, src]
        is_pad = (t[None, :] < pad[:, None])[..., None]
        return torch.where(is_pad, self._silence_vec.to(out.dtype), out)


class WaveformFrontend:
    """fn({"wave": (B, L), "length": (B,)}, rng=None, params=None) ->
    (B, n_samples) waveforms on ``device``: with an ``augmenter`` every
    utterance draws a channel over the whole (B, L) buffer first (``rng``
    and ``params`` as for :class:`OnDeviceFrontend`), then sample t of an
    utterance of ``length`` samples reads sample t mod length (the ASVspoof
    RawNet2 baseline's repeat padding; the JAX ``WaveformFrontend``)."""

    def __init__(self, n_samples: int = 64600, augmenter=None,
                 apply_ir: bool = False, device="cuda"):
        self.n_samples = n_samples
        self.augmenter = augmenter
        self.apply_ir = apply_ir
        self.device = resolve_device(device)

    def min_samples(self) -> int:
        """The waveform buffer length the model reads."""
        return self.n_samples

    @property
    def params(self):
        """The augmenter's tables (None without an augmenter)."""
        return None if self.augmenter is None else self.augmenter.tables

    def eval_view(self) -> "WaveformFrontend":
        """Augmenter-free copy, for the eval step."""
        view = copy.copy(self)
        view.augmenter = None
        view.apply_ir = False
        return view

    def __call__(self, batch: Dict[str, torch.Tensor], rng=None,
                 params=None) -> torch.Tensor:
        wave = batch["wave"].to(self.device)
        lengths = batch.get("length")
        if lengths is None:
            lengths = torch.full((wave.shape[0],), wave.shape[1])
        lengths = lengths.to(self.device).long()
        if self.augmenter is not None:
            if rng is None:
                raise ValueError("the channel augmenter needs rng: its draws "
                                 "or a torch.Generator")
            wave, _fam, _ir = self.augmenter(wave, rng, self.apply_ir,
                                             params)
        t = torch.arange(self.n_samples, device=self.device)
        idx = t[None, :] % torch.clamp(lengths[:, None], min=1)
        return torch.gather(wave, 1, idx)
