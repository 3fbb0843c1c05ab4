"""The port's LCNN against the JAX package's, on the CPU at B = 8, F = 60,
T = feat_len = 48, embedding 16: ``bn_train`` (values and VJP), the weight
map both ways (the head's flatten permuted between NHWC and NCHW), eval
mode in f32, train mode with the JAX model's own dropout mask injected
(outputs, BN statistics, gradients), and bf16 against the JAX model's
bf16. The helpers are tests/test_torch_resnet.py's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.interop.torch_port import port_lcnn
from asvspoof2021_air_tpu.ops.bn_relu_vjp import bn_train as j_bn_train
from asvspoof2021_air_tpu_torch.interop.checkpoints import (
    lcnn_from_state_dict)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables, random_flax_variables)
from asvspoof2021_air_tpu_torch.models.common import MaxFeatureMap
from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import bn_train
from test_torch_resnet import (
    ENC, RUNNING, check_bf16, check_bn_vjp, check_f32, jax_model, run_pair)
from test_torch_train_families import _two_threads  # noqa: F401

T = 48


def test_bn_train_matches_jax():
    check_bn_vjp(j_bn_train, bn_train, 1)


def test_weight_map_inverts_port_lcnn_and_matches_the_flax_tree():
    """``from_flax_variables`` is the inverse of the JAX package's
    ``port_lcnn`` (bit for bit, the head's rows permuted), the seeded tree
    has the JAX model's init names and shapes, the affine-free BNs hold
    only their statistics, and ``lcnn_from_state_dict`` rebuilds the model
    (feat_len from the head's width)."""
    v = random_flax_variables(0, model="lcnn", enc_dim=ENC, feat_len=T)
    sd = from_flax_variables(v, model="lcnn")
    back = port_lcnn({k: t.numpy() for k, t in sd.items()}, 60, T)
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    a, b = flat(v), flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    init = jax.eval_shape(lambda: jax_model("lcnn", T).init(
        jax.random.PRNGKey(0), jnp.zeros((2, T, 60)), False))
    assert {k: x.shape for k, x in a.items()} == {
        jax.tree_util.keystr(p): tuple(x.shape) for p, x in
        jax.tree_util.tree_flatten_with_path(init)[0]}
    assert sd["out.1.weight"].shape == (160, 32 * 3 * 3)
    assert not [k for k in sd if k.startswith("conv2.2.")
                and not k.endswith(RUNNING)]
    model = lcnn_from_state_dict(sd, device="cpu")
    assert not model.training and model.flat == 288
    assert set(model.state_dict()) == set(sd)


def test_max_feature_map_splits_the_channel_axis():
    x = torch.arange(24.0).reshape(1, 4, 2, 3)
    y = MaxFeatureMap()(x)
    assert torch.equal(y, torch.maximum(x[:, :2], x[:, 2:]))
    with pytest.raises(ValueError, match="even"):
        MaxFeatureMap()(torch.zeros(1, 3, 2, 2))


def test_lcnn_eval_matches_jax():
    """Embedding and logits in f32, 1e-4 of the largest magnitude."""
    check_f32(run_pair("lcnn", T, 1, train=False))


def test_lcnn_train_mode_matches_jax_with_its_dropout():
    """Train mode, JAX's dropout mask injected (permuted to the NCHW
    flatten): embedding, logits and the six BNs' running statistics
    within 1e-4 of their largest magnitude; every parameter gradient of
    sum emb^2 + sum logits^2 within 2e-4 of its tensor's largest (the JAX
    model's f32 gradients are 3.6e-5 from the port's float64 ones)."""
    pairs = run_pair("lcnn", T, 2, train=True, with_grads=True)
    assert sum(k.endswith(RUNNING) for k in pairs) == 12
    check_f32(pairs, grad_bar=2e-4)


@pytest.mark.parametrize("train", [False, True])
def test_lcnn_bf16_matches_jax_bf16(train):
    check_bf16("lcnn", T, 3, train)
