"""Port Res2 chain (B2's plain version and parameter packing,
asvspoof2021_air_tpu_torch/ops/res2_chain_cuda.py) against the JAX package's
res2_chain_infer (Pallas, interpret mode) in f32.

Tolerance atol 1e-4: the JAX kernel's own bar against the model's chain math
(tests/test_res2_chain_pallas.py); seven chained f32 convs summed in another
order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.ops.res2_chain_pallas import (
    pack_chain_params as jpack,
    res2_chain_infer as jchain,
)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables,
    random_flax_variables,
)
from asvspoof2021_air_tpu_torch.ops.res2_chain_cuda import (
    pack_chain_params,
    res2_chain_infer,
    res2_chain_plain,
)

C, SCALE = 64, 8
DILATION_OF = {2: "layer1", 3: "layer2", 4: "layer3"}


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(3, C=C, model_scale=SCALE, enc_dim=32,
                                 stat_noise=0.1)


@pytest.mark.parametrize("dilation", [2, 3, 4])
@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("T,valid_len", [(48, 47), (48, None)])
def test_plain_chain_matches_pallas(variables, B, T, valid_len, dilation):
    li = dilation - 2
    p = variables["params"][f"Bottle2neck_{li}"]
    bs = variables["batch_stats"][f"Bottle2neck_{li}"]
    # rows past valid_len hold garbage: both sides must ignore them
    x = (np.random.default_rng(B * T + dilation).standard_normal((B, T, C))
         * 2.0).astype(np.float32)
    want = np.asarray(jchain(jnp.asarray(x), *jpack(p, bs, scale=SCALE),
                             dilation=dilation, scale=SCALE,
                             valid_len=valid_len, interpret=True))
    sd = from_flax_variables(variables, SCALE)
    packed = pack_chain_params(sd, DILATION_OF[dilation], SCALE)
    got = res2_chain_infer(torch.from_numpy(x), *packed, dilation=dilation,
                           scale=SCALE, valid_len=valid_len).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    if valid_len is not None:
        np.testing.assert_array_equal(got[:, valid_len:], 0.0)


def test_packed_params_match_jax(variables):
    sd = from_flax_variables(variables, SCALE)
    for li, block in enumerate(("layer1", "layer2", "layer3")):
        want = jpack(variables["params"][f"Bottle2neck_{li}"],
                     variables["batch_stats"][f"Bottle2neck_{li}"],
                     scale=SCALE)
        got = pack_chain_params(sd, block, SCALE)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_bf16_plain_chain_tracks_pallas_bf16(variables):
    """bf16 I/O: both round sp + g and the BN output to bf16 at the same
    points; tolerance two bf16 ulps at the outputs' magnitude (~4)."""
    p = variables["params"]["Bottle2neck_1"]
    bs = variables["batch_stats"]["Bottle2neck_1"]
    x = np.random.default_rng(0).standard_normal((2, 40, C)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jchain(xb, *jpack(p, bs, scale=SCALE), dilation=3,
                             scale=SCALE, interpret=True), np.float32)
    packed = pack_chain_params(from_flax_variables(variables, SCALE),
                               "layer2", SCALE)
    got = res2_chain_plain(torch.from_numpy(x).bfloat16(), *packed,
                           dilation=3, scale=SCALE).float().numpy()
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=2e-2)


def test_jax_tree_from_the_weight_maker_runs_in_jax(variables):
    """The numpy maker's tree is a valid ECAPA_TDNN variable tree."""
    model = JECAPA(C=C, model_scale=SCALE, enc_dim=32)
    emb, logits = model.apply(jax.tree.map(jnp.asarray, variables),
                              jnp.zeros((1, 20, 60)), False)
    assert emb.shape == (1, 32) and logits.shape == (1, 2)
