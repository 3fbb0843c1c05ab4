"""On-device channel augmentation: IR convolution, companding, band-limiting,
level normalization, bitrate-shaped noise.

Counterpart of the JAX package's ``ops/augment.py``. The JAX augmenter is
plain ``jnp`` with XLA's FFT, no Pallas kernel; this port is plain PyTorch
with ``torch.fft`` (cuFFT on the card). Per utterance, a small
time-domain channel kernel is assembled (the family's FIR prototype,
optionally convolved with a random impulse response by a small FFT) and
applied to the batch with one big rFFT/irFFT pair; companding and noise
are elementwise, selected per utterance by arithmetic masks as in JAX.

Two differences of form, none of value:

- the family's rows are gathered by index where JAX multiplies a one-hot
  by the table (``_arith_onehot(...) @ table``). Both give the row exactly
  (a one-hot product adds zeros), but on the card a product could run in
  TF32 and round the FIRs;
- the randomness is split from the arithmetic: :meth:`ChannelAugmenter.draw`
  makes the draws (family and IR uniforms (B,), noise normal (B, L)) from
  a ``torch.Generator``, :meth:`ChannelAugmenter.apply` takes them from
  outside. The JAX augmenter draws the same three from its key
  (``augment.py:319-336``), so a test can hand JAX's draws to the port.

The FIR prototypes and the IR synthesizers are numpy, bitwise copies of
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.ops import dsp


def _next_pow2(n: int) -> int:
    return int(2 ** np.ceil(np.log2(max(n, 2))))


# ---------------------------------------------------------------------------
# FIR prototypes (numpy, used only to derive frequency responses)
# ---------------------------------------------------------------------------

def lowpass_fir(cutoff: float, sr: int, taps: int = 127) -> np.ndarray:
    """Hamming-windowed-sinc low-pass FIR prototype."""
    t = np.arange(taps) - (taps - 1) / 2.0
    h = 2.0 * cutoff / sr * np.sinc(2.0 * cutoff / sr * t)
    h *= np.hamming(taps)
    return (h / h.sum()).astype(np.float32)


def bandpass_fir(low: float, high: float, sr: int,
                 taps: int = 127) -> np.ndarray:
    """Band-pass FIR: low-pass(high) minus low-pass(low)."""
    lp_hi = lowpass_fir(high, sr, taps)
    lp_lo = lowpass_fir(low, sr, taps)
    return (lp_hi - lp_lo).astype(np.float32)


def fir_response(fir: np.ndarray, n_fft: int) -> np.ndarray:
    """Zero-phase magnitude response of an FIR (the linear-phase delay is
    discarded so augmentation does not shift audio)."""
    H = np.fft.rfft(fir, n=n_fft)
    return np.abs(H).astype(np.float32)


# ---------------------------------------------------------------------------
# Frequency-domain linear channel application
# ---------------------------------------------------------------------------

def apply_response(waves: torch.Tensor, H: torch.Tensor,
                   n_fft: int) -> torch.Tensor:
    """y = irfft(rfft(x) * H)[:L]: batched linear filtering; H (B, NF) or
    (NF,)."""
    L = waves.shape[-1]
    X = torch.fft.rfft(waves, n=n_fft, dim=-1)
    y = torch.fft.irfft(X * H, n=n_fft, dim=-1)
    return y[..., :L].to(waves.dtype)


def ir_convolve(waves: torch.Tensor, irs: torch.Tensor,
                ir_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched FFT convolution with an impulse-response bank: waves (B, L),
    irs (N, K), ir_idx (B,) picks one IR per utterance (IR 0 for all when
    None). The first L samples of the linear convolution."""
    B, L = waves.shape
    K = irs.shape[-1]
    sel = irs[ir_idx.long()] if ir_idx is not None else irs[:1].expand(B, K)
    n = _next_pow2(L + K - 1)
    H = torch.fft.rfft(sel, n=n, dim=-1)
    return apply_response(waves, H, n)


def fir_filter(waves: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Delay-compensated FIR filtering in the frequency domain."""
    L = waves.shape[-1]
    n = _next_pow2(L + len(kernel))
    # keep the true (complex) response but undo the linear-phase delay
    H = np.fft.rfft(np.asarray(kernel, np.float64), n=n)
    delay = (len(kernel) - 1) / 2.0
    k = np.arange(H.shape[0])
    H = H * np.exp(2j * np.pi * k * delay / n)
    return apply_response(
        waves, torch.from_numpy(H.astype(np.complex64)).to(waves.device), n)


def telephony_bandlimit(waves: torch.Tensor,
                        wideband: bool = False) -> torch.Tensor:
    """300-3400 Hz (narrowband) or 50-7000 Hz (wideband) band-limiting."""
    if wideband:
        fir = lowpass_fir(7000.0, 16000)
    else:
        fir = bandpass_fir(300.0, 3400.0, 16000)
    return fir_filter(waves, fir)


# ---------------------------------------------------------------------------
# Level normalization
# ---------------------------------------------------------------------------

def rms_normalize(waves: torch.Tensor, target_dbfs,
                  lengths: Optional[torch.Tensor] = None,
                  eps: float = 1e-12) -> torch.Tensor:
    """Scale each utterance so its RMS level is ``target_dbfs`` (dB full
    scale), over its first ``lengths`` samples when given."""
    if lengths is None:
        ms = torch.mean(waves ** 2, dim=-1)
    else:
        mask = (torch.arange(waves.shape[-1], device=waves.device)[None, :]
                < lengths[:, None]).to(waves.dtype)
        ms = torch.sum((waves * mask) ** 2, dim=-1) / torch.clamp(
            lengths.to(waves.dtype), min=1.0)
    rms = torch.sqrt(ms + eps)
    target = 10.0 ** (torch.as_tensor(target_dbfs, dtype=waves.dtype,
                                      device=waves.device) / 20.0)
    return waves * (target / rms)[:, None]


# ---------------------------------------------------------------------------
# Companding quantization (G.711 simulation, elementwise)
# ---------------------------------------------------------------------------

_MU = 255.0
_LOG1P_MU = float(np.log1p(np.float32(_MU)))


def mulaw_quantize(x: torch.Tensor) -> torch.Tensor:
    """8-bit mu-law companded quantization round trip; rounds by
    floor(x + 0.5), as the JAX function does."""
    x = torch.clamp(x, -1.0, 1.0)
    x_mu = torch.sign(x) * torch.log1p(_MU * torch.abs(x)) / _LOG1P_MU
    code = torch.floor((x_mu + 1.0) / 2.0 * _MU + 0.5)
    x_back = (code / _MU) * 2.0 - 1.0
    return torch.sign(x_back) * (torch.exp(torch.abs(x_back) * _LOG1P_MU)
                                 - 1.0) / _MU


def alaw_quantize(x: torch.Tensor) -> torch.Tensor:
    """8-bit A-law companded quantization round trip; rounds half to even
    (``torch.round``, as ``jnp.round``)."""
    x = torch.clamp(x, -1.0, 1.0)
    q = torch.round(dsp.alaw_encode(x) * 127.0) / 127.0
    return dsp.alaw_decode(q)


def g711_sim(waves: torch.Tensor, law: str = "u") -> torch.Tensor:
    """G.711 u-law/A-law hop: band-limit, then 8-bit companded
    quantization."""
    x = telephony_bandlimit(waves)
    return mulaw_quantize(x) if law == "u" else alaw_quantize(x)


def bitrate_noise(waves: torch.Tensor, noise: torch.Tensor,
                  snr_db) -> torch.Tensor:
    """Additive noise at a per-utterance SNR, the lossy codecs' quantization
    noise proxy. ``noise`` is the standard-normal draw of waves' shape (the
    JAX function draws it from its key); an SNR of +inf adds nothing."""
    sig_pow = torch.mean(waves ** 2, dim=-1, keepdim=True) + 1e-12
    snr_db = torch.as_tensor(snr_db, dtype=waves.dtype,
                             device=waves.device)[:, None]
    scale = torch.where(torch.isfinite(snr_db),
                        torch.sqrt(sig_pow / (10.0 ** (snr_db / 10.0))),
                        torch.zeros((), dtype=waves.dtype,
                                    device=waves.device))
    return waves + noise * scale


# ---------------------------------------------------------------------------
# Channel augmenter: a random channel per utterance
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChannelFamily:
    """Parametric on-device stand-in for one codec family."""
    name: str
    wideband: bool
    law: Optional[str]       # 'u'|'a' for companded families
    snr_db: float            # bitrate-shaped noise level (inf = none)


# The JAX package's family table, its SNRs feature-matched against its
# native real-codec tier (``asvspoof2021_air_tpu/ops/augment.py:197-217``).
CHANNEL_FAMILIES: Tuple[ChannelFamily, ...] = (
    ChannelFamily("clean", True, None, np.inf),
    ChannelFamily("g711u", False, "u", np.inf),
    ChannelFamily("g711a", False, "a", np.inf),
    ChannelFamily("g726", False, None, 16.5),
    ChannelFamily("amr_nb", False, None, 15.0),
    ChannelFamily("amr_wb", True, None, 18.0),
    ChannelFamily("silk_nb", False, None, 15.0),
    ChannelFamily("silk_wb", True, None, 28.0),
    ChannelFamily("g722", True, None, 37.0),
    ChannelFamily("gsmfr", False, None, 12.2),
)

_LAW_NONE, _LAW_MU, _LAW_A = 0, 1, 2

Draws = Dict[str, torch.Tensor]


class ChannelAugmenter:
    """A random channel per utterance: ``aug(waves, rng, apply_ir, tables)
    -> (augmented waves, family index, IR index)``, the indices as float32
    (B,), as the JAX augmenter returns them.

    ``rng`` is a ``torch.Generator`` on the waves' device, from which
    :meth:`draw` makes the draws, or the draws themselves (a dict from
    :meth:`draw`, or JAX's in a test). ``tables`` defaults to
    :attr:`tables` (the JAX augmenter takes them as an argument of its
    jitted program; the port takes them for the same call form).

    The noise covers the whole (B, L) buffer, padding included, as do the
    signal power it is scaled by, and the families without noise add it at
    a 200 dB sentinel SNR (``noise * ~1e-10 * rms``), as in JAX."""

    N_FFT = 131072  # covers 7.5 s utterances + IR tails
    TAPS = 128      # family FIR prototype length

    def __init__(self, families: Sequence[ChannelFamily] = CHANNEL_FAMILIES,
                 ir_bank: Optional[np.ndarray] = None,
                 n_fft: Optional[int] = None, device="cuda"):
        self.families = tuple(families)
        self.n_fft = n_fft or self.N_FFT
        self.device = resolve_device(device)

        firs, laws, snrs = [], [], []
        for fam in self.families:
            fir = np.zeros(self.TAPS, np.float32)
            if fam.name == "clean":
                fir[self.TAPS // 2] = 1.0  # pure delay (compensated below)
            elif fam.wideband:
                fir[: self.TAPS - 1] = lowpass_fir(7000.0, 16000,
                                                   self.TAPS - 1)
            else:
                fir[: self.TAPS - 1] = bandpass_fir(300.0, 3400.0, 16000,
                                                    self.TAPS - 1)
            firs.append(fir)
            laws.append({None: _LAW_NONE, "u": _LAW_MU, "a": _LAW_A}[fam.law])
            # inf encoded as a large sentinel, as in JAX
            snrs.append(200.0 if not np.isfinite(fam.snr_db) else fam.snr_db)

        if ir_bank is None:
            ir_np = np.zeros((1, self.TAPS), np.float32)
            ir_np[0, 0] = 1.0
            self._has_ir = False
        else:
            ir_np = np.asarray(ir_bank, np.float32)
            self._has_ir = True
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self.ir_bank = on(ir_np)
        self.tables = {
            "fam_fir": on(np.stack(firs)),                   # (F, TAPS)
            "laws": on(np.array(laws, np.float32)),          # (F,)
            "snrs": on(np.array(snrs, np.float32)),          # (F,)
            "irs": self.ir_bank,                             # (N, K)
        }

    def draw(self, shape, generator: torch.Generator,
             out: Optional[Draws] = None) -> Draws:
        """The randomness of one call on waves of ``shape`` (B, L): the
        family and IR uniforms (B,) in [0, 1) and the noise, standard
        normal (B, L), all float32 on the generator's device; written into
        ``out``'s tensors where given (the same values)."""
        B, L = shape
        out = out or {}
        kw = dict(generator=generator, device=generator.device,
                  dtype=torch.float32)
        return {"fam": torch.rand(B, out=out.get("fam"), **kw),
                "ir": torch.rand(B, out=out.get("ir"), **kw),
                "noise": torch.randn(B, L, out=out.get("noise"), **kw)}

    def apply(self, waves: torch.Tensor, draws: Draws,
              apply_ir: bool = False, tables=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The channel of ``draws`` on ``waves`` (B, L): (out, family index,
        IR index), the JAX augmenter's arithmetic (``augment.py:312-368``)
        with its draws given."""
        tb = self.tables if tables is None else tables
        B, L = waves.shape
        n_fam = tb["fam_fir"].shape[0]
        n_ir = tb["irs"].shape[0]

        # floor(uniform * n): an index in [0, n - 1] for a float32 uniform
        # in [0, 1 - 2^-24]
        fam_f = torch.floor(draws["fam"] * n_fam)
        fam_i = fam_f.long()
        fir = tb["fam_fir"][fam_i]                           # (B, TAPS)

        ir_f = torch.zeros(B, dtype=torch.float32, device=waves.device)
        kernel, k_len = fir, self.TAPS
        if apply_ir and self._has_ir:
            ir_f = torch.floor(draws["ir"] * n_ir)
            irs = tb["irs"][ir_f.long()]                     # (B, K)
            # the FIR and the IR combined by a small FFT convolution
            m = _next_pow2(self.TAPS + tb["irs"].shape[1])
            K1 = torch.fft.rfft(fir, n=m, dim=-1)
            K2 = torch.fft.rfft(irs, n=m, dim=-1)
            kernel = torch.fft.irfft(K1 * K2, n=m, dim=-1)
            k_len = m
        if L + k_len > self.n_fft:
            raise ValueError(f"utterance length {L} too long for augmenter "
                             f"n_fft {self.n_fft}")

        # the per-utterance kernel through one big FFT pair; the TAPS/2
        # prototype delay compensated by the slice
        H = torch.fft.rfft(kernel, n=self.n_fft, dim=-1)
        X = torch.fft.rfft(waves, n=self.n_fft, dim=-1)
        y = torch.fft.irfft(X * H, n=self.n_fft, dim=-1)
        delay = self.TAPS // 2
        out = y[:, delay:delay + L].to(waves.dtype)

        # companding law per utterance, by arithmetic masks as in JAX
        law = tb["laws"][fam_i][:, None]                     # (B, 1)
        mu_m = torch.clamp(1.0 - torch.abs(law - _LAW_MU), min=0.0)
        a_m = torch.clamp(1.0 - torch.abs(law - _LAW_A), min=0.0)
        out = ((1.0 - mu_m - a_m) * out + mu_m * mulaw_quantize(out)
               + a_m * alaw_quantize(out))

        # bitrate-shaped noise; the 200 dB sentinel adds ~1e-10 of it
        snr = tb["snrs"][fam_i]
        sig_pow = torch.mean(out ** 2, dim=-1, keepdim=True) + 1e-12
        scale = torch.sqrt(sig_pow / (10.0 ** (snr[:, None] / 10.0)))
        out = out + draws["noise"] * scale
        return out, fam_f, ir_f

    def __call__(self, waves: torch.Tensor,
                 rng: Union[torch.Generator, Draws],
                 apply_ir: bool = False, tables=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        draws = (self.draw(waves.shape, rng)
                 if isinstance(rng, torch.Generator) else rng)
        return self.apply(waves, draws, apply_ir, tables)


# ---------------------------------------------------------------------------
# Impulse-response synthesizers (numpy)
# ---------------------------------------------------------------------------

def synthetic_ir_bank(n_irs: int = 13, length: int = 512, seed: int = 0,
                      sr: int = 16000) -> np.ndarray:
    """Synthetic device/room IR bank (exponentially decaying noise with a
    direct path), the stand-in for a recorded IR corpus."""
    g = np.random.default_rng(seed)
    t = np.arange(length) / sr
    bank = np.zeros((n_irs, length), np.float32)
    for i in range(n_irs):
        decay = np.exp(-t / (0.01 + 0.05 * g.random()))
        tail = g.standard_normal(length) * decay * 0.3
        tail[0] = 1.0
        bank[i] = tail / np.abs(tail).sum()
    return bank


def synthesize_device_ir(g: np.random.Generator, length: int = 1024,
                         sr: int = 16000) -> np.ndarray:
    """Loudspeaker/telephone-class impulse response: damped modal
    resonances inside a band-pass envelope."""
    t = np.arange(length) / sr
    ir = np.zeros(length)
    n_modes = g.integers(3, 8)
    lo = g.uniform(150.0, 500.0)          # low roll-off
    hi = g.uniform(2500.0, 7000.0)        # top roll-off
    for _ in range(n_modes):
        f = np.exp(g.uniform(np.log(lo * 1.2), np.log(hi * 0.9)))
        tau = g.uniform(0.5e-3, 6e-3)     # short decays: device resonances
        amp = g.uniform(0.3, 1.0)
        ir += amp * np.sin(2 * np.pi * f * t + g.uniform(0, 2 * np.pi)) * \
            np.exp(-t / tau)
    # band-pass the whole response (FFT brickwall with soft edges)
    spec = np.fft.rfft(ir)
    freqs = np.fft.rfftfreq(length, 1 / sr)
    shape = 1.0 / (1 + (lo / np.maximum(freqs, 1.0)) ** 4)
    shape *= 1.0 / (1 + (freqs / hi) ** 6)
    ir = np.fft.irfft(spec * shape, n=length)
    ir /= np.abs(ir).sum() + 1e-12
    return ir.astype(np.float32)


def synthesize_space_ir(g: np.random.Generator, length: int = 8192,
                        sr: int = 16000) -> np.ndarray:
    """Room-class impulse response: direct path, sparse early reflections,
    then an exponentially decaying diffuse tail at a sampled RT60."""
    t = np.arange(length) / sr
    ir = np.zeros(length)
    ir[0] = 1.0
    n_early = g.integers(4, 12)
    for _ in range(n_early):
        d = int(g.uniform(0.002, 0.025) * sr)
        if d < length:
            ir[d] += g.uniform(0.1, 0.6) * g.choice([-1.0, 1.0])
    rt60 = g.uniform(0.08, 0.6)
    tau = rt60 / 6.91                      # ln(1000)
    tail = g.standard_normal(length) * np.exp(-t / tau)
    mix_at = int(0.02 * sr)
    ir[mix_at:] += 0.35 * tail[mix_at:]
    ir /= np.abs(ir).sum() + 1e-12
    return ir.astype(np.float32)
