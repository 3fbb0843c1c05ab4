"""The port's channel augmenter (``ops/augment.py``), its companding helpers
(``ops/dsp.py``) and the augmenting ``OnDeviceFrontend`` against the JAX
package, on the CPU at small sizes (L = 8000 samples, n_fft 16384).

Tolerances: the label helpers exactly; the other companding helpers 1e-6;
the FIR prototypes and the IR synthesizers bitwise (numpy copies); each
augment function and the augmenter 1e-5 (float32 FFTs of 16384 points in
two libraries). A quantizer's output is a code of a 256-level law, and an
FFT's rounding can move a sample across a code boundary: there at least
99.9% of the samples agree to 1e-5 and every other sample is one code
step away. The front-end's features agree to the bar of the clean
front-end's test (``tests/test_torch_scoring.py``), 5e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.ops import augment as jaug
from asvspoof2021_air_tpu.ops import dsp as jdsp
from asvspoof2021_air_tpu.train.frontend import OnDeviceFrontend as JFrontend
from asvspoof2021_air_tpu_torch.ops import augment as aug
from asvspoof2021_air_tpu_torch.ops import dsp
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

B, L, N_FFT = 4, 8000, 16384


def _waves(seed: int, b: int = B, n: int = L) -> np.ndarray:
    """Speech-like test signals: a few tones plus noise, some loud enough
    to clip in the companders, one quiet."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    out = np.zeros((b, n))
    for i in range(b):
        for _ in range(3):
            out[i] += g.uniform(0.05, 0.4) * np.sin(
                2 * np.pi * g.uniform(100, 7000) * t + g.uniform(0, 6))
        out[i] += 0.05 * g.standard_normal(n)
    out[-1] *= 0.01
    return out.astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _codes(x: np.ndarray, law: str) -> np.ndarray:
    """The 8-bit code nearest to each sample of a law's output, in
    float64."""
    x = np.clip(x.astype(np.float64), -1, 1)
    if law == "u":
        y = np.sign(x) * np.log1p(255 * np.abs(x)) / np.log1p(255)
        return np.floor((y + 1) / 2 * 255 + 0.5)
    return np.round(np.asarray(jdsp.alaw_encode(jnp.asarray(x)),
                               np.float64) * 127)


def assert_quantized_close(got, want, law: str):
    """>= 99.9% of the samples within 1e-5, each other one code step
    away."""
    got, want = np.asarray(got), np.asarray(want)
    close = np.abs(got - want) <= 1e-5
    assert close.mean() >= 0.999, close.mean()
    step = np.abs(_codes(got, law) - _codes(want, law))
    assert (step[~close] <= 1).all(), step[~close].max()


# ---- companding helpers ----

def test_label_helpers_exactly():
    g = np.random.default_rng(0)
    codes = g.integers(0, 256, 100).astype(np.float32)
    np.testing.assert_array_equal(dsp.label_2_float(_t(codes), 8).numpy(),
                                  np.asarray(jdsp.label_2_float(
                                      jnp.asarray(codes), 8)))
    for scale in (0.7, 1.6):            # within [-1, 1], then peak-normalized
        x = (scale * np.sin(np.arange(300) / 7.0)).astype(np.float32)
        np.testing.assert_array_equal(
            dsp.float_2_label(_t(x), 8).numpy(),
            np.asarray(jdsp.float_2_label(jnp.asarray(x), 8)))


@pytest.mark.parametrize("fn", ["mulaw", "alaw"])
def test_companding_round_trips_match_jax(fn):
    x = np.linspace(-0.999, 0.999, 4001, dtype=np.float32)
    if fn == "mulaw":
        for scale in (True, False):
            got = dsp.mulaw_encode(_t(x), 256, scale)
            want = np.asarray(jdsp.mulaw_encode(jnp.asarray(x), 256, scale))
            if scale:
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
            np.testing.assert_allclose(
                dsp.mulaw_decode(got, 256, scale).numpy(),
                np.asarray(jdsp.mulaw_decode(jnp.asarray(want), 256, scale)),
                atol=1e-6)
    else:
        enc = dsp.alaw_encode(_t(x))
        np.testing.assert_allclose(
            enc.numpy(), np.asarray(jdsp.alaw_encode(jnp.asarray(x))),
            atol=1e-6)
        np.testing.assert_allclose(
            dsp.alaw_decode(enc).numpy(),
            np.asarray(jdsp.alaw_decode(jnp.asarray(enc.numpy()))),
            atol=1e-6)


# ---- numpy copies, bitwise ----

def test_fir_prototypes_and_ir_synthesizers_bitwise():
    pairs = [
        (aug.lowpass_fir(7000.0, 16000), jaug.lowpass_fir(7000.0, 16000)),
        (aug.lowpass_fir(3000.0, 8000, 63), jaug.lowpass_fir(3000.0, 8000,
                                                             63)),
        (aug.bandpass_fir(300.0, 3400.0, 16000),
         jaug.bandpass_fir(300.0, 3400.0, 16000)),
        (aug.fir_response(aug.bandpass_fir(300.0, 3400.0, 16000), 1024),
         jaug.fir_response(jaug.bandpass_fir(300.0, 3400.0, 16000), 1024)),
        (aug.synthetic_ir_bank(), jaug.synthetic_ir_bank()),
        (aug.synthetic_ir_bank(5, 256, seed=3), jaug.synthetic_ir_bank(
            5, 256, seed=3)),
    ]
    for seed in range(3):
        pairs.append((aug.synthesize_device_ir(np.random.default_rng(seed)),
                      jaug.synthesize_device_ir(
                          np.random.default_rng(seed))))
        pairs.append((aug.synthesize_space_ir(np.random.default_rng(seed)),
                      jaug.synthesize_space_ir(np.random.default_rng(seed))))
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert [f.name for f in aug.CHANNEL_FAMILIES] == [
        f.name for f in jaug.CHANNEL_FAMILIES]
    for a, b in zip(aug.CHANNEL_FAMILIES, jaug.CHANNEL_FAMILIES):
        assert (a.wideband, a.law, a.snr_db) == (b.wideband, b.law, b.snr_db)


# ---- each augment function, L = 8000, 1e-5 ----

def test_linear_channel_functions_match_jax():
    x = _waves(1)
    g = np.random.default_rng(2)
    H = g.uniform(0, 1.5, (B, N_FFT // 2 + 1)).astype(np.float32)
    irs = aug.synthetic_ir_bank(3, 300, seed=4)
    idx = np.array([2, 0, 1, 2], np.int32)
    fir = aug.bandpass_fir(300.0, 3400.0, 16000)
    cases = [
        (aug.apply_response(_t(x), _t(H), N_FFT),
         jaug.apply_response(jnp.asarray(x), jnp.asarray(H), N_FFT)),
        (aug.ir_convolve(_t(x), _t(irs), _t(idx)),
         jaug.ir_convolve(jnp.asarray(x), jnp.asarray(irs), jnp.asarray(idx))),
        (aug.ir_convolve(_t(x), _t(irs)),
         jaug.ir_convolve(jnp.asarray(x), jnp.asarray(irs))),
        (aug.fir_filter(_t(x), fir), jaug.fir_filter(jnp.asarray(x), fir)),
    ]
    for wide in (False, True):
        cases.append((aug.telephony_bandlimit(_t(x), wide),
                      jaug.telephony_bandlimit(jnp.asarray(x), wide)))
    for got, want in cases:
        assert got.shape == (B, L) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_level_and_noise_functions_match_jax():
    x = _waves(3)
    target = np.array([-26.0, -29.0, -32.0, -35.0], np.float32)
    lengths = np.array([L, 5000, 1200, 7999], np.int32)
    for lens in (None, lengths):
        got = aug.rms_normalize(_t(x), _t(target),
                                None if lens is None else _t(lens))
        want = jaug.rms_normalize(jnp.asarray(x), jnp.asarray(target),
                                  None if lens is None
                                  else jnp.asarray(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    key = jax.random.PRNGKey(5)
    snr = np.array([12.2, np.inf, 37.0, 15.0], np.float32)
    noise = np.asarray(jax.random.normal(key, (B, L), jnp.float32))
    got = aug.bitrate_noise(_t(x), _t(noise), _t(snr))
    want = jaug.bitrate_noise(jnp.asarray(x), key, jnp.asarray(snr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), x[1])     # +inf: nothing


@pytest.mark.parametrize("law", ["u", "a"])
def test_quantizers_and_g711_match_jax(law):
    """The quantizers on the same input to 1e-5 (no FFT before them);
    G.711 filters by FFT first, so a sample may cross a code boundary."""
    x = 1.3 * _waves(6)                 # a few samples past full scale
    q, jq = ((aug.mulaw_quantize, jaug.mulaw_quantize) if law == "u"
             else (aug.alaw_quantize, jaug.alaw_quantize))
    np.testing.assert_allclose(q(_t(x)).numpy(), np.asarray(
        jq(jnp.asarray(x))), rtol=0, atol=1e-5)
    assert_quantized_close(aug.g711_sim(_t(x), law).numpy(),
                           jaug.g711_sim(jnp.asarray(x), law), law)


# ---- the augmenter, with JAX's draws injected ----

def jax_draws(key, b: int, n: int):
    """The draws the JAX augmenter makes from ``key``
    (``asvspoof2021_air_tpu/ops/augment.py:319-336``), as the port's
    draws."""
    k_fam, k_noise, k_ir = jax.random.split(key, 3)
    return {"fam": _t(jax.random.uniform(k_fam, (b,), jnp.float32)),
            "ir": _t(jax.random.uniform(k_ir, (b,), jnp.float32)),
            "noise": _t(jax.random.normal(k_noise, (b, n), jnp.float32))}


def _augmenters(families, apply_ir):
    bank = aug.synthetic_ir_bank() if apply_ir else None
    return (aug.ChannelAugmenter(families, ir_bank=bank, n_fft=N_FFT,
                                 device="cpu"),
            jaug.ChannelAugmenter(families, ir_bank=bank, n_fft=N_FFT))


def _check_augmenter(families, apply_ir, seed):
    x = _waves(seed)
    key = jax.random.PRNGKey(seed)
    port, ref = _augmenters(families, apply_ir)
    got, fam, ir = port(_t(x), jax_draws(key, B, L), apply_ir=apply_ir)
    want, jfam, jir = ref(jnp.asarray(x), key, apply_ir=apply_ir)
    np.testing.assert_array_equal(fam.numpy(), np.asarray(jfam))
    np.testing.assert_array_equal(ir.numpy(), np.asarray(jir))
    assert got.shape == (B, L) and got.dtype == torch.float32
    laws = {families[int(f)].law for f in fam.numpy()}
    if laws & {"u", "a"}:
        for i, f in enumerate(fam.numpy().astype(int)):
            law = families[f].law
            if law is None:
                np.testing.assert_allclose(got[i].numpy(),
                                           np.asarray(want[i]), atol=1e-5)
            else:
                assert_quantized_close(got[i].numpy(), want[i], law)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    return fam.numpy(), ir.numpy()


@pytest.mark.parametrize("apply_ir", [False, True])
@pytest.mark.parametrize("family", [f.name for f in aug.CHANNEL_FAMILIES])
def test_single_family_augmenter_matches_jax(family, apply_ir):
    fam = next(f for f in aug.CHANNEL_FAMILIES if f.name == family)
    _, ir = _check_augmenter((fam,), apply_ir, seed=10)
    assert (ir > 0).any() == apply_ir      # IR indices drawn only with IRs


@pytest.mark.parametrize("apply_ir", [False, True])
def test_mixed_family_augmenter_matches_jax(apply_ir):
    fams = set()
    for seed in (20, 21, 22):
        fam, _ = _check_augmenter(aug.CHANNEL_FAMILIES, apply_ir, seed)
        fams |= set(fam.tolist())
    assert len(fams) >= 5


def test_augmenter_draws_tables_and_limits():
    port, _ = _augmenters(aug.CHANNEL_FAMILIES, True)
    ref = jaug.ChannelAugmenter(ir_bank=aug.synthetic_ir_bank(), n_fft=N_FFT)
    for k, v in port.tables.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref.tables[k]))
    assert (port.N_FFT, port.TAPS) == (ref.N_FFT, ref.TAPS) == (131072, 128)
    # the draws are the generator's alone, and the call draws them itself
    gen = lambda: torch.Generator().manual_seed(3)
    d1, d2 = port.draw((B, L), gen()), port.draw((B, L), gen())
    assert {k: v.shape for k, v in d1.items()} == {
        "fam": (B,), "ir": (B,), "noise": (B, L)}
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    x = _t(_waves(4))
    a = port(x, gen(), apply_ir=True)
    b = port.apply(x, d1, apply_ir=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # the tables handed in are the ones used
    tb = dict(port.tables, snrs=torch.zeros_like(port.tables["snrs"]))
    loud = port.apply(x, d1, tables=tb)[0]          # noise at 0 dB SNR
    assert (loud - port.apply(x, d1)[0]).abs().max() > 0.1
    with pytest.raises(ValueError, match="too long"):
        port(_t(_waves(0, 1, N_FFT - 1000)), gen(), apply_ir=True)


# ---- the augmenting front-end ----

@pytest.mark.parametrize("padding", ["repeat", "zero", "silence"])
def test_augmenting_frontend_matches_jax(padding):
    """The augmenter runs on the whole (B, L_max) buffer before LFCC, the
    padding after it; JAX's front-end with its key, the port's with the
    draws JAX makes from that key, which pick G.711 A-law, G.711 u-law and
    G.726 with IRs."""
    feat_len = 40
    fams = aug.CHANNEL_FAMILIES
    bank = aug.synthetic_ir_bank()
    x = _waves(30, 3, 7000)
    lengths = np.array([7000, 3000, 900], np.int32)
    key = jax.random.PRNGKey(51)
    draws = jax_draws(key, 3, 7000)
    assert np.floor(draws["fam"].numpy() * 10).tolist() == [2, 1, 3]
    jfe = JFrontend(feat_len=feat_len, padding=padding, use_pallas=False,
                    augmenter=jaug.ChannelAugmenter(fams, bank, N_FFT),
                    apply_ir=True)
    want = np.asarray(jfe({"wave": jnp.asarray(x),
                           "length": jnp.asarray(lengths)}, key, jfe.params))
    fe = OnDeviceFrontend(feat_len=feat_len, padding=padding,
                          augmenter=aug.ChannelAugmenter(fams, bank, N_FFT,
                                                         device="cpu"),
                          apply_ir=True, device="cpu")
    batch = {"wave": _t(x), "length": _t(lengths)}
    got = fe(batch, draws, fe.params).numpy()
    assert got.shape == want.shape == (3, feat_len, 60)
    np.testing.assert_allclose(got, want, atol=5e-4)
    clean = fe.eval_view()
    assert clean.augmenter is None and clean.params is None
    assert fe.augmenter is not None and fe.params is not None
    assert not np.allclose(clean(batch).numpy(), got, atol=1e-2)
    with pytest.raises(ValueError, match="rng"):
        fe(batch)
