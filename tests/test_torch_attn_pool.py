"""Port attention pooling (B3's plain version and parameter packing,
asvspoof2021_air_tpu_torch/ops/attn_pool_cuda.py) against the JAX package's
fused_attention_pooling (Pallas, interpret mode) in f32.

Tolerance atol 2e-5, rtol 1e-5: the JAX kernel's own bar against the
model's pooling math (tests/test_attn_pool_pallas.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asvspoof2021_air_tpu.ops.attn_pool_pallas import fused_attention_pooling
from asvspoof2021_air_tpu_torch.ops.attn_pool_cuda import (
    attention_pooling,
    pack_pool_params,
)

D = 1536


def _params(seed):
    g = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * g.standard_normal(s)).astype(np.float32)
    return {
        "attn_kernel": f(3 * D, 128, sc=0.05),
        "attn_bias": f(128, sc=0.01),
        "bn": {"scale": 1 + f(128, sc=0.1), "bias": f(128, sc=0.1),
               "mean": f(128, sc=0.2),
               "var": (1 + 0.3 * g.random(128)).astype(np.float32)},
        "conv_kernel": f(1, 128, D, sc=0.05),
        "conv_bias": f(D, sc=0.01),
    }


def _port_state_dict(p):
    """The same weights under the port's reference names."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return {
        "attention.0.weight": t(p["attn_kernel"].T[:, :, None]),
        "attention.0.bias": t(p["attn_bias"]),
        "attention.2.weight": t(p["bn"]["scale"]),
        "attention.2.bias": t(p["bn"]["bias"]),
        "attention.2.running_mean": t(p["bn"]["mean"]),
        "attention.2.running_var": t(p["bn"]["var"]),
        "attention.3.weight": t(np.transpose(p["conv_kernel"], (2, 1, 0))),
        "attention.3.bias": t(p["conv_bias"]),
    }


@pytest.mark.parametrize("T,valid_len", [(50, None), (50, 37), (24, 21)])
def test_plain_pooling_matches_pallas(T, valid_len):
    B = 3
    p = _params(T)
    g = np.random.default_rng(T + 1)
    x = g.standard_normal((B, T, D)).astype(np.float32)
    if valid_len is not None:   # garbage past valid_len must be ignored
        x[:, valid_len:] *= 7.0
    want = np.asarray(fused_attention_pooling(
        jnp.asarray(x), jnp.asarray(p["attn_kernel"]),
        jnp.asarray(p["attn_bias"]),
        {k: jnp.asarray(v) for k, v in p["bn"].items()},
        jnp.asarray(p["conv_kernel"]), jnp.asarray(p["conv_bias"]),
        interpret=True, valid_len=valid_len))
    params = pack_pool_params(_port_state_dict(p))
    got = attention_pooling(torch.from_numpy(x), params,
                            valid_len=valid_len).numpy()
    assert got.shape == (B, 2 * D)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
