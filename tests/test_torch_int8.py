"""The port's int8 serving tiers (``serving/ecapa_int8.py``) and weights-only
quantization (``ops/quantize.py``) against the JAX package's, on the CPU
(JAX's Pallas kernels in interpret mode), at C = 64.

Tolerances:
- the weight codes and scales, ``quantized_bytes`` and the dequantized
  weights: bitwise (the same f32 division and half-to-even rounding);
- ``qdot``: bitwise in f32 (an exact int32 sum times the same f32 scale);
  within one bf16 ulp in bf16 (the cast of the int32 sum may round twice
  in one package and once in the other);
- ``ecapa_apply_int8`` in f32: the embedding and logits within 0.1 x JAX's
  own int8-vs-f32 distance (the port must be ten times closer to JAX than
  quantization moves JAX), and at least 99.9% of every site's int8 codes
  equal (two f32 graphs that sum in other orders may put a value on the
  other side of a rounding edge); the unquantized tier (no int8 error to
  measure against) within 1e-4, the scorer's bar of
  ``test_torch_scoring.py``;
- in bf16: within 2 x JAX's own bf16-vs-f32 distance of the same tier
  (the port's bf16 convention: the two packages round at other places);
- ``calibrate_act_scales``: the same nine sites, rtol 1e-5;
- the corpus bar of ``tests/test_ecapa_int8.py``: |EER_f32 - EER_int8|
  <= 1/32 on a system the port trains in 40 steps.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.ops import quantize as jquant
from asvspoof2021_air_tpu.serving import ecapa_int8 as jint8
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables, random_flax_variables)
from asvspoof2021_air_tpu_torch.ops import quantize as pquant
from asvspoof2021_air_tpu_torch.serving import ecapa_apply_int8
from asvspoof2021_air_tpu_torch.serving.ecapa_int8 import (
    SITES, calibrate_act_scales, qdot, quant_w)

C, ENC, B, SCALE = 64, 32, 2, 8
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

disable_tf32()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch runs: beside the suite's
    other workers, torch's default of a thread per core oversubscribes the
    CPU (the 40 training steps below took 359 s in a six-worker run of
    the suite, 3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(scale=SCALE):
    v = random_flax_variables(3, C=C, model_scale=scale, enc_dim=ENC)
    return v, from_flax_variables(v, scale)


@functools.lru_cache(maxsize=None)
def _feats(T, seed=0):
    return np.random.default_rng(seed + T).standard_normal(
        (B, T, 60)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_scales(scale=SCALE):
    v, _ = _weights(scale)
    batches = [jnp.asarray(_feats(48, seed=s)) for s in (10, 11)]
    return jint8.calibrate_act_scales(v, batches, model_scale=scale,
                                      enc_dim=ENC, interpret=True)


def _to_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_tier(T, quantize, fused_chain, calibrated, dtype):
    """JAX's (embedding, logits, {site: activation}) for one tier."""
    v, _ = _weights()
    seen = {}
    emb, logits = jint8.ecapa_apply_int8(
        v, jnp.asarray(_feats(T)), model_scale=SCALE, enc_dim=ENC,
        dtype=DTYPES[dtype][0], interpret=True, fused_chain=fused_chain,
        quantize=quantize,
        act_scales=_jax_scales() if calibrated else None,
        observer=lambda s, a: seen.__setitem__(s, _to_np(a)))
    return _to_np(emb), _to_np(logits), seen


def _port_tier(T, quantize, fused_chain, calibrated, dtype):
    _, sd = _weights()
    seen = {}
    with torch.no_grad():
        emb, logits = ecapa_apply_int8(
            sd, torch.from_numpy(_feats(T)), model_scale=SCALE,
            dtype=DTYPES[dtype][1], fused_chain=fused_chain,
            quantize=quantize,
            act_scales=_jax_scales() if calibrated else None,
            observer=lambda s, a: seen.__setitem__(s, a.float().numpy()),
            device="cpu")
    return emb.numpy(), logits.numpy(), seen


def _codes(v, scale):
    s = np.float32(max(float(np.abs(v).max()), 1e-12) / 127.0
                   if scale is None else scale)
    return np.clip(np.round(v / s), -127, 127)


def _dist(a, b):
    return float(np.abs(a - b).max())


# (quantize, fused_chain, T, calibrated). Every tier runs the fused chain
# at T = 50, where it pads to 56 and the dynamic scales read the padded
# rows, and the plain chain with dynamic (T = 50) and calibrated (T = 48)
# scales; the full int8 tier also runs the fused chain at T = 48 and with
# calibrated scales. (JAX's fused chain costs about 2 s a call here, in
# interpret mode, so not every pairing runs.)
TIERS = [True, "mfa", False]
F32_CASES = [(q, fc, t, cal) for q in TIERS for fc, t, cal in (
    (True, 50, False), (False, 50, False), (False, 48, True))] + [
    (True, True, 48, False), (True, True, 50, True)]
BF16_CASES = [(q, fc, t, cal) for q in TIERS for fc, t, cal in (
    (False, 50, False), (False, 48, True))] + [(True, True, 50, False)]


@pytest.mark.parametrize("quantize,fused_chain,T,calibrated", F32_CASES)
def test_int8_tiers_track_jax_f32(quantize, fused_chain, T, calibrated):
    want = _jax_tier(T, quantize, fused_chain, calibrated, "f32")
    got = _port_tier(T, quantize, fused_chain, calibrated, "f32")
    f32 = _jax_tier(T, False, False, False, "f32")
    if quantize is False:
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    else:
        for g, w, ref in zip(got[:2], want[:2], f32[:2]):
            jax_int8 = _dist(w, ref)
            assert jax_int8 > 0              # quantization did move JAX
            assert _dist(g, w) <= 0.1 * jax_int8, (_dist(g, w), jax_int8)
    want_sites = set(SITES) if quantize is True else {"mfa_0", "mfa_1",
                                                      "mfa_2"}
    assert set(got[2]) == set(want[2]) == want_sites
    scales = _jax_scales()
    for site in want_sites:
        assert got[2][site].shape == want[2][site].shape, site
        s = scales[site] if calibrated else None
        same = np.mean(_codes(got[2][site], s) == _codes(want[2][site], s))
        assert same >= 0.999, (site, same)


@pytest.mark.parametrize("quantize,fused_chain,T,calibrated", BF16_CASES)
def test_int8_tiers_track_jax_bf16(quantize, fused_chain, T, calibrated):
    want = _jax_tier(T, quantize, fused_chain, calibrated, "bf16")
    got = _port_tier(T, quantize, fused_chain, calibrated, "bf16")
    ref = _jax_tier(T, quantize, fused_chain, calibrated, "f32")
    for g, w, r in zip(got[:2], want[:2], ref[:2]):
        assert np.isfinite(g).all()
        assert _dist(g, w) <= 2 * _dist(w, r), (_dist(g, w), _dist(w, r))


def test_calibrate_act_scales_matches_jax():
    _, sd = _weights()
    batches = [_feats(48, seed=s) for s in (10, 11)]
    got = calibrate_act_scales(sd, batches, model_scale=SCALE, device="cpu")
    want = _jax_scales()
    assert set(got) == set(want) == set(SITES)
    for site in SITES:
        np.testing.assert_allclose(got[site], want[site], rtol=1e-5)
    with_room = calibrate_act_scales(sd, batches, model_scale=SCALE,
                                     headroom=1.1, device="cpu")
    for site in SITES:
        np.testing.assert_allclose(with_room[site], 1.1 * got[site],
                                   rtol=1e-6)


def test_quant_w_is_bitwise_jax():
    g = np.random.default_rng(0)
    w = (g.standard_normal((64, 48)) * 0.1).astype(np.float32)
    w[:, 3] = 0.0                        # a zero column: the 1e-12 floor
    q, s = quant_w(torch.from_numpy(w))
    jq, js = jint8._quant_w(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qdot_matches_jax(dtype, static):
    """f32 bitwise; bf16 within one bf16 ulp of JAX's result."""
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 40, 64)).astype(np.float32)
    w = (g.standard_normal((64, 32)) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    act = 0.021 if static else None
    xj = jnp.asarray(x, jdt)
    jw8, jws = jint8._quant_w(jnp.asarray(w))
    want = _to_np(jint8._qdot(xj, jw8, jws, jdt, act_scale=act))
    w8, ws = quant_w(torch.from_numpy(w))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = qdot(xt, w8, ws, tdt, act_scale=act)
    assert got.dtype == tdt and got.shape == (2, 40, 32)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_array_equal(got, want)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def _jax_tree(qt, pick):
    """The JAX record's leaves through ``pick`` as a variables tree."""
    return jax.tree_util.tree_unflatten(
        qt["treedef"], [pick(rec) for rec in qt["leaves"]])


@pytest.mark.parametrize("model", ["ecapa", "lcnn"])
def test_quantize_state_dict_is_bitwise_jax(model):
    """Codes and scales (each broadcast to its kernel's shape) through the
    interop map equal the port's; the byte counts are JAX's; dequantized
    weights are bitwise JAX's dequantized tree mapped."""
    kw = dict(C=C, model_scale=4, enc_dim=ENC) if model == "ecapa" else \
        dict(model="lcnn", enc_dim=ENC, feat_len=32)
    v = random_flax_variables(4, **kw)
    to_port = lambda tree: from_flax_variables(
        jax.tree.map(np.asarray, tree), 4, model=model)
    sd = to_port(v)
    qt = jquant.quantize_tree_int8(v)
    qsd = pquant.quantize_state_dict_int8(sd)
    assert list(qsd) == list(sd)
    n_q = sum(rec[0] == "q" for rec in qsd.values())
    assert n_q == sum(rec[0] == "q" for rec in qt["leaves"]) > 0
    codes = to_port(_jax_tree(qt, lambda r: r[1].astype(np.float32)
                              if r[0] == "q" else r[1]))
    scales = to_port(_jax_tree(qt, lambda r: np.broadcast_to(
        r[2], r[1].shape) if r[0] == "q" else r[1]))
    for name, rec in qsd.items():
        if rec[0] == "q":
            assert rec[1].dtype == torch.int8, name
            np.testing.assert_array_equal(rec[1].float().numpy(),
                                          codes[name].numpy())
            np.testing.assert_array_equal(
                rec[2].expand_as(rec[1]).numpy(), scales[name].numpy())
        else:
            np.testing.assert_array_equal(rec[1].numpy(),
                                          codes[name].numpy())
    assert pquant.quantized_bytes(qsd) == jquant.quantized_bytes(qt)
    back = pquant.dequantize_state_dict(qsd)
    want = to_port(jquant.dequantize_tree(qt))
    for name in sd:
        np.testing.assert_array_equal(back[name].numpy(),
                                      want[name].numpy())
    qb, fb = pquant.quantized_bytes(qsd)
    assert qb < 0.35 * fb


def test_int8_eer_delta_on_synthetic_corpus():
    """The JAX package's corpus bar: a C = 64 system the port trains for 40
    steps on a separable synthetic corpus scores a held-out set through
    the f32 graph and the calibrated int8 tier with the same EER within
    1/32."""
    from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
    from asvspoof2021_air_tpu_torch.metrics.eer import compute_eer
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.serving.ecapa_serving import (
        ServingECAPA)
    from asvspoof2021_air_tpu_torch.train.state import create_train_state
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_train_step)

    nb, T, scale, steps, sep = 8, 48, 4, 40, 0.25
    g = np.random.default_rng(11)
    labels = (np.arange(nb) % 2).astype(np.int64)
    feats = (g.standard_normal((steps, nb, T, 60))
             + sep * labels[None, :, None, None]).astype(np.float32)
    model = ECAPA_TDNN(C=C, model_scale=scale, enc_dim=ENC, device="cpu")
    model.load_state_dict(from_flax_variables(random_flax_variables(
        0, C=C, model_scale=scale, enc_dim=ENC), scale))
    loss = OCSoftmax(feat_dim=ENC, r_real=0.9, r_fake=0.2, alpha=20.0,
                     device="cpu")
    state = create_train_state(model, loss, lambda _: 1e-3)
    step = make_train_step(StepConfig(add_loss="ang_iso"), device="cpu")
    torch.manual_seed(0)
    for s in range(steps):
        step(state, {"feat": torch.from_numpy(feats[s]),
                     "label": torch.from_numpy(labels)})

    n_hold = 64
    hold_labels = (np.arange(n_hold) % 2).astype(np.int64)
    hold = torch.from_numpy((g.standard_normal((n_hold, T, 60))
                             + sep * hold_labels[:, None, None]
                             ).astype(np.float32))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    scales = calibrate_act_scales(sd, [feats[0], feats[1]],
                                  model_scale=scale, device="cpu")
    with torch.no_grad():
        emb_f32, _ = ServingECAPA(sd, dtype=torch.float32, model_scale=scale,
                                  device="cpu")(hold)
        emb_i8, _ = ecapa_apply_int8(sd, hold, model_scale=scale,
                                     dtype=torch.float32, act_scales=scales,
                                     device="cpu")

    def eer_of(emb):
        with torch.no_grad():
            _, score = loss(emb, torch.from_numpy(hold_labels))
        s = -score.numpy()               # +cos: bona fide (0) scores high
        return compute_eer(s[hold_labels == 0], s[hold_labels == 1])[0]

    eer_f32, eer_i8 = eer_of(emb_f32), eer_of(emb_i8)
    assert eer_f32 < 0.25
    assert abs(eer_f32 - eer_i8) <= 1.0 / 32 + 1e-9, (eer_f32, eer_i8)
