"""The port's CQCC front-end (``ops/cqcc.py``) against the JAX package's,
on the CPU at L <= 16000 samples: the features and ``log_cq`` equal
JAX's; the bars of tests/test_cqcc.py held against the port's CQCC
(shape, tone localization, constant-Q spacing and bandwidth, the
resample matrix's partition, variable length); the on-the-fly
``OnDeviceFrontend(feature="CQCC")`` under each padding policy against
JAX's, and the training loop on the fly with CQCC.

Tolerances. The constants (kernels, halfband filter, resampling and DCT
matrices) are built by the same numpy code in both packages and are held
bitwise. Both packages compute in f32, and log(power + eps) magnifies
the summation-order noise of quiet bins, so each bar is read in the test
from JAX's own distance to a float64 reference on the same input (the
port's CQCC with its constants cast to float64, the same formula): the
port within twice that distance of JAX. Readings (seeds 0-2): JAX's
features 5.0e-4 - 5.3e-4 from float64 (values up to 360), its log_cq
3.3e-5 - 6.0e-5 (up to 16); the port's own distance 0.55 - 1.30 of JAX's,
the port to JAX 0.59 - 1.25 of it. The ported
tests/test_cqcc.py bars are its own (peaks within 2 bins, widths within
max(3, half), partition 1e-5, interior frames 2e-2)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.ops import cqcc as jcqcc
from asvspoof2021_air_tpu.train.frontend import (
    OnDeviceFrontend as JFrontend)
from asvspoof2021_air_tpu_torch.ops.cqcc import (
    CQCC, CQCCConfig, cq_kernels, halfband_fir, uniform_resample_matrix)
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
from torch_threads import one_thread  # noqa: F401

B, L = 3, 16000
LENS = np.array([16000, 9000, 12345])


def waves(seed: int) -> np.ndarray:
    """(B, L) f32 noise and tones, each row zero past its LENS length."""
    g = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    w = 0.1 * g.standard_normal((B, L)) + 0.2 * np.sin(
        2 * np.pi * g.uniform(80, 6000, (B, 1)) * t)
    for r, n in enumerate(LENS):
        w[r, n:] = 0.0
    return w.astype(np.float32)


def float64_cqcc() -> CQCC:
    """The port's CQCC with its constants cast to float64: the float64
    value of the function both packages compute in f32."""
    m = CQCC(device="cpu")
    m.kernels = [k.double() for k in m.kernels]
    m.hb, m.resample, m.dct = (t.double() for t in (m.hb, m.resample, m.dct))
    return m


_JAX = {}


def jax_cqcc():
    if "cqcc" not in _JAX:
        ex = jcqcc.CQCC(jcqcc.CQCCConfig())
        _JAX["cqcc"] = (ex, jax.jit(ex.__call__), jax.jit(ex.log_cq))
    return _JAX["cqcc"]


def check_by_jax_distance(port, jax_out, ref) -> float:
    d_jax = float(np.abs(jax_out - ref).max())
    assert 0 < d_jax < 1e-2
    diff = float(np.abs(port - jax_out).max())
    assert diff <= 2 * d_jax, (diff, d_jax)
    return d_jax


def test_constants_equal_jax_bitwise():
    cfg, jcfg = CQCCConfig(), jcqcc.CQCCConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert np.array_equal(halfband_fir(), jcqcc.halfband_fir())
    assert np.array_equal(uniform_resample_matrix(cfg),
                          jcqcc.uniform_resample_matrix(jcfg))
    nu = np.array([0.125, 0.2, 0.249])
    for a, b in zip(cq_kernels(nu, 138.0, 2048),
                    jcqcc.cq_kernels(nu, 138.0, 2048)):
        assert np.array_equal(a, b)
    port, (jex, _f, _l) = CQCC(device="cpu"), jax_cqcc()
    assert port.oct_stage == jex._oct_stage
    assert port.n_stages == jex.n_stages
    for k, (re, im) in zip(port.kernels, jex._kernels):
        assert np.array_equal(k.numpy(), np.concatenate([re, im], 1))
    assert np.array_equal(port.dct.numpy(), jex._dct)


@pytest.mark.parametrize("seed", [0, 1])
def test_cqcc_and_log_cq_equal_jax(seed):
    w = waves(seed)
    _jex, j_call, j_log = jax_cqcc()
    port, ref = CQCC(device="cpu"), float64_cqcc()
    tw, tl = torch.from_numpy(w), torch.from_numpy(LENS)
    got = port(tw, tl).numpy()
    want = np.asarray(j_call(jnp.asarray(w), jnp.asarray(LENS)))
    assert got.shape == want.shape == (B, 1 + L // 160, 90)
    check_by_jax_distance(got, want, ref(tw.double(), tl).numpy())
    got, want = port.log_cq(tw).numpy(), np.asarray(j_log(jnp.asarray(w)))
    assert got.shape == (B, 1 + L // 160, 7 * 96)
    check_by_jax_distance(got, want, ref.log_cq(tw.double()).numpy())


# ---- tests/test_cqcc.py's bars, against the port's CQCC ----

def tone(freq, n=L, sr=16000, amp=0.3):
    t = np.arange(n) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def mid_frame_cq(ex, freq):
    cq = ex.log_cq(torch.from_numpy(tone(freq)[None])).numpy()[0]
    return cq[cq.shape[0] // 2]


def test_output_shape():
    w = np.random.default_rng(0).standard_normal((3, L)).astype(np.float32)
    out = CQCC(device="cpu")(torch.from_numpy(w)).numpy()
    assert out.shape == (3, 101, 90)
    assert np.isfinite(out).all()


def test_cq_tone_localization():
    """A tone peaks at its geometric bin in every octave (each octave runs
    at its own decimation stage)."""
    cfg, ex = CQCCConfig(), CQCC(device="cpu")
    for freq in (100.0, 250.0, 440.0, 1000.0, 3000.0, 6000.0):
        expected = int(round(np.log2(freq / cfg.fmin)
                             * cfg.bins_per_octave))
        peak = int(np.argmax(mid_frame_cq(ex, freq)))
        assert abs(peak - expected) <= 2, (freq, peak, expected)


def test_constant_q_spacing_and_bandwidth():
    """Octave-shifted tones land bins_per_octave apart, and a tone's
    half-max width in bins is the same in a low and a high octave."""
    cfg, ex = CQCCConfig(), CQCC(device="cpu")
    peak = lambda f: int(np.argmax(mid_frame_cq(ex, f)))
    assert abs(peak(1000.0) - peak(500.0) - cfg.bins_per_octave) <= 2
    assert abs(peak(4000.0) - peak(2000.0) - cfg.bins_per_octave) <= 2

    def width_bins(freq):
        p = np.exp(mid_frame_cq(ex, freq).astype(np.float64))
        k = int(np.argmax(p))
        lo = hi = k
        while lo > 0 and p[lo] > p[k] / 2:
            lo -= 1
        while hi < len(p) - 1 and p[hi] > p[k] / 2:
            hi += 1
        return hi - lo

    w_low, w_high = width_bins(200.0), width_bins(3200.0)
    assert abs(w_low - w_high) <= max(3, 0.5 * w_high), (w_low, w_high)


def test_resample_matrix_partition():
    M = uniform_resample_matrix(CQCCConfig())
    np.testing.assert_allclose(M.sum(axis=0), 1.0, atol=1e-5)
    assert np.all((M >= 0) & (M <= 1))


def test_variable_length_matches_per_utterance():
    ex = CQCC(device="cpu")
    g = np.random.default_rng(1)
    lens = [8000, 16000]
    batch = np.zeros((2, max(lens)), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = 0.3 * g.standard_normal(n)
    out = ex(torch.from_numpy(batch), torch.tensor(lens)).numpy()
    single = ex(torch.from_numpy(batch[:1, :lens[0]])).numpy()
    T0, margin = 1 + lens[0] // 160, 8
    np.testing.assert_allclose(out[0, margin:T0 - margin, :30],
                               single[0, margin:, :30][:T0 - 2 * margin],
                               atol=2e-2)


# ---- the on-the-fly front-end ----

@pytest.mark.parametrize("padding", ["repeat", "zero", "silence"])
def test_on_device_frontend_cqcc_equals_jax(padding):
    """Features of a (B, L) batch with lengths at feat_len 120 (> T, so
    every policy pads) by the bar of the CQCC it gathers, read on the
    same batch; the silence frames against JAX's silence vector."""
    w = waves(2)
    feat_len = 120
    port = OnDeviceFrontend(feat_len=feat_len, padding=padding,
                            device="cpu", feature="CQCC")
    jfe = JFrontend(feat_len=feat_len, padding=padding, feature="CQCC")
    assert port.hop == jfe.hop == 160
    batch = {"wave": torch.from_numpy(w), "length": torch.from_numpy(LENS)}
    got = port(batch).numpy()
    want = np.asarray(jax.jit(lambda b: jfe(b, jax.random.PRNGKey(0)))(
        {"wave": jnp.asarray(w), "length": jnp.asarray(LENS)}))
    assert got.shape == want.shape == (B, feat_len, 90)
    d_jax = float(np.abs(
        np.asarray(jax_cqcc()[1](jnp.asarray(w), jnp.asarray(LENS)))
        - float64_cqcc()(batch["wave"].double(), batch["length"]).numpy()
    ).max())
    assert 0 < d_jax < 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * d_jax)
    if padding == "silence":
        np.testing.assert_allclose(port._silence_vec.numpy(),
                                   np.asarray(jfe._silence_vec), rtol=0,
                                   atol=2 * d_jax)
    with pytest.raises(ValueError, match="LFCC/CQCC"):
        OnDeviceFrontend(device="cpu", feature="STFT")


def test_train_on_the_fly_with_cqcc(tmp_path):
    """``train()`` with ``feat="CQCC"`` on the fly (90 dims, as the JAX
    config takes it); STFT and Melspec on the fly are refused with JAX's
    ValueError."""
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, check_supported, train)
    from test_torch_train import _write_part

    _write_part(str(tmp_path), "train", 8, 0, 6000)
    _write_part(str(tmp_path), "dev", 8, 1, 6000)
    cfg = TrainConfig(
        out_fold=str(tmp_path / "run"), path_to_database=str(tmp_path),
        on_the_fly=True, feat="CQCC", feat_dim=90, feat_len=32,
        model="ecapa", C=16, model_scale=4, enc_dim=16, add_loss="ang_iso",
        batch_size=8, num_epochs=1, ratio=1.0)
    summary = train(cfg, device="cpu")
    assert summary["epochs"] == 1 and np.isfinite(summary["dev_loss"])
    for feat in ("STFT", "Melspec"):
        with pytest.raises(ValueError, match="LFCC/CQCC"):
            check_supported(dataclasses.replace(cfg, feat=feat))
