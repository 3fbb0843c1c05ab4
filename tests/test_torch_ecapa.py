"""Port ECAPA (weights carried across, the unfused eval forward and the
fused serving graph) against the JAX package, in f32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.interop.torch_port import port_ecapa
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.serving.ecapa_int8 import ecapa_apply_int8
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.interop.flax_weights import from_flax_variables
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.serving.ecapa_serving import (
    ServingECAPA,
    ecapa_apply_serving,
)

C, SCALE, ENC = 64, 8, 32

disable_tf32()


def _variables(seed, T=48):
    """JAX-initialized variables with BN statistics perturbed (as
    tests/test_ecapa_int8.py does) so the inference BN is exercised."""
    model = JECAPA(C=C, model_scale=SCALE, n_out=2, n_feat=60, enc_dim=ENC)
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           jnp.zeros((2, T, 60)), False)
    variables = jax.tree.map(
        lambda v: v + 0.05 * jnp.asarray(
            np.random.default_rng(seed + 1).standard_normal(v.shape),
            v.dtype),
        variables)
    return model, jax.tree.map(np.asarray, variables)


def _feats(B, T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, 60)).astype(
        np.float32)


def test_from_flax_variables_round_trips_through_port_ecapa():
    _, variables = _variables(0)
    sd = from_flax_variables(variables, SCALE)
    back = port_ecapa({k: v.numpy() for k, v in sd.items()}, SCALE)
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf)
    # and the port module accepts exactly this state_dict
    ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC,
               device="cpu").load_state_dict(sd)


def test_eval_forward_matches_jax_model():
    """f32, atol 3e-5 / rtol 1e-4: the JAX package's fused-vs-model bar
    (tests/test_attn_pool_pallas.py)."""
    model, variables = _variables(1)
    feats = _feats(3, 48, 2)
    want_emb, want_logits = model.apply(variables, jnp.asarray(feats), False)
    port = ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC,
                      device="cpu").eval()
    port.load_state_dict(from_flax_variables(variables, SCALE))
    with torch.no_grad():
        emb, logits = port(torch.from_numpy(feats))
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), atol=3e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("T,pad", [(47, 0), (48, 0), (47, 1)])
def test_serving_graph_matches_jax_serving(T, pad):
    """The port's serving graph against ecapa_apply_int8(quantize=False,
    fused_chain=True) in f32, atol 2e-3 / rtol 1e-3 (the JAX package's bar
    for that tier, tests/test_ecapa_int8.py). With pad=1 the port runs T+1
    rows of which the last is garbage, masked by valid_len=T."""
    _, variables = _variables(2)
    feats = _feats(3, T, 3)
    want_emb, want_logits = ecapa_apply_int8(
        variables, jnp.asarray(feats), model_scale=SCALE, enc_dim=ENC,
        dtype=jnp.float32, interpret=True, fused_chain=True, quantize=False)
    sd = from_flax_variables(variables, SCALE)
    x = np.concatenate([feats, 9.0 * _feats(3, pad, 4)], axis=1)
    with torch.no_grad():
        emb, logits = ecapa_apply_serving(
            sd, torch.from_numpy(x), dtype=torch.float32,
            valid_len=T if pad else None, model_scale=SCALE, device="cpu")
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=2e-3, rtol=1e-3)


def test_bf16_serving_tracks_f32_model():
    """bf16 compute against the port's own f32 unfused forward: embedding
    cosine >= 0.999 at this small width (the full-width bar, 0.9996, is
    checked on the GPU by chip_smoke.py)."""
    _, variables = _variables(3)
    feats = torch.from_numpy(_feats(2, 48, 5))
    sd = from_flax_variables(variables, SCALE)
    port = ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC,
                      device="cpu").eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        want, _ = port(feats)
        got, _ = ServingECAPA(sd, dtype=torch.bfloat16, model_scale=SCALE,
                              device="cpu")(feats)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert got.dtype == torch.float32
    assert torch.all(cos >= 0.999), cos
