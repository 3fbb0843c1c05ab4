"""The JAX ECAPA-TDNN's variant fields in the port (``context``,
``summed``, ``encoder_type``, ``out_bn``), against the JAX package on the
CPU at C = 32, scale 4, B = 8, T = 40, f32.

Each variant's JAX variables (BN scales, biases and statistics perturbed,
so that the eval affine is not the identity) load into the port through
``interop/flax_weights.from_flax_variables`` and map back through the JAX
package's ``interop/torch_port.port_ecapa`` bit for bit; the port's eval
and train forwards (embedding, logits) and, in train mode, the updated BN
statistics are held within 1e-4 of the largest value of each tensor of
JAX's. Train mode is each package's fused training path (fused_pool and
fused_bn on; JAX's Pallas VJP in interpret mode); a one-channel attention
(a non-"ECA" encoder) never pools through the fused kernels, in either
package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.interop.torch_port import port_ecapa
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables, random_flax_variables)
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from torch_threads import one_thread  # noqa: F401

C, SCALE, ENC, B, T = 32, 4, 16, 8, 40
VARIANTS = {
    "no_context": dict(context=False),
    "summed": dict(summed=True),
    "one_channel": dict(encoder_type="SAP"),
    "no_out_bn": dict(out_bn=False),
    "all": dict(context=False, summed=True, encoder_type="SAP",
                out_bn=False),
}
_VARIABLES = {}

disable_tf32()


def _jmodel(variant: str, fused: bool):
    return JECAPA(C=C, model_scale=SCALE, n_out=2, n_feat=60, enc_dim=ENC,
                  fused_pool=fused, pool_interpret=fused, fused_bn=fused,
                  **VARIANTS[variant])


def _feats(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, T, 60)).astype(
        np.float32)


def _variables(variant: str):
    """The JAX model's init for ``variant``, every leaf moved by 0.05
    standard normal draws (the BN variances by 0.05 uniform ones)."""
    if variant not in _VARIABLES:
        v = jax.jit(lambda k, x: _jmodel(variant, False).init(
            {"params": k}, x, False))(jax.random.PRNGKey(0),
                                      jnp.asarray(_feats(0)))
        g = np.random.default_rng(1)

        def perturb(path, a):
            a = np.asarray(a)
            if jax.tree_util.keystr(path).endswith("['var']"):
                return (a + 0.05 * g.random(a.shape)).astype(np.float32)
            return (a + 0.05 * g.standard_normal(a.shape)).astype(np.float32)

        _VARIABLES[variant] = jax.tree_util.tree_map_with_path(perturb, v)
    return _VARIABLES[variant]


def _port(variant: str, variables) -> ECAPA_TDNN:
    port = ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, device="cpu",
                      **VARIANTS[variant])
    port.load_state_dict(from_flax_variables(variables, SCALE))
    return port


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (what, err,
                                              np.abs(want).max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_weights_round_trip(variant):
    """from_flax_variables, then port_ecapa back: every leaf of the JAX
    tree bit for bit (port_ecapa reads ``bn7`` always, so without
    ``out_bn`` it is given a stand-in and its BatchNorm_3 dropped); the
    state_dict loads into the port's variant strictly, and
    ``random_flax_variables`` makes the same tree's names and shapes."""
    v = _variables(variant)
    sd = from_flax_variables(v, SCALE)
    out_bn = VARIANTS[variant].get("out_bn", True)
    assert ("bn7.weight" in sd) == out_bn
    stand_in = {} if out_bn else {
        f"bn7.{k}": torch.ones(2) for k in ("weight", "bias",
                                            "running_mean", "running_var")}
    back = port_ecapa({k: t.numpy() for k, t in {**sd, **stand_in}.items()},
                      SCALE)
    if not out_bn:
        del back["params"]["BatchNorm_3"], back["batch_stats"]["BatchNorm_3"]
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
    _port(variant, v)
    rand = random_flax_variables(0, C=C, model_scale=SCALE, enc_dim=ENC,
                                 model_kwargs=VARIANTS[variant])
    shapes = lambda t: {jax.tree_util.keystr(p): np.shape(a) for p, a in
                        jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(rand) == shapes(v)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(variant, train):
    """Embedding and logits within 1e-4 of the largest |value| of JAX's;
    in train mode every updated BN running statistic too."""
    v = _variables(variant)
    feats = _feats(2)
    out, mut = jax.jit(lambda x: _jmodel(variant, train).apply(
        v, x, train, mutable=["batch_stats"]))(jnp.asarray(feats))
    port = _port(variant, v).train(train)
    with torch.no_grad():
        emb, logits = port(torch.from_numpy(feats))
    _close(emb, out[0], "embedding")
    _close(logits, out[1], "logits")
    if train:
        want = from_flax_variables({"params": v["params"],
                                    "batch_stats": jax.tree.map(
                                        np.asarray, mut["batch_stats"])},
                                   SCALE)
        got = port.state_dict()
        for k, w in want.items():
            if k.endswith(("running_mean", "running_var")):
                _close(got[k], w, k)


@pytest.mark.parametrize("fused_pool", [None, True])
def test_one_channel_attention_never_fuses(monkeypatch, fused_pool):
    """A non-"ECA" encoder gives ``attention.3`` one output channel, and
    its train and eval forwards never call FusedSoftmaxStats, with
    ``fused_pool`` None or True (the JAX rule, ``models/ecapa.py:270``
    there); the embedding broadcasts the one softmax over every
    channel."""
    import asvspoof2021_air_tpu_torch.models.ecapa as ecapa_mod

    def refused(*a, **k):
        raise AssertionError("a one-channel attention reached the kernels")

    monkeypatch.setattr(ecapa_mod, "fused_softmax_stats", refused)
    model = ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, device="cpu",
                       fused_pool=fused_pool, encoder_type="SAP")
    assert model.attention[3].weight.shape == (1, 128, 1)
    x = torch.from_numpy(_feats(3))
    for train in (True, False):
        emb, logits = model.train(train)(x)
        assert emb.shape == (B, ENC) and logits.shape == (B, 2)
        assert bool(torch.isfinite(emb).all())
