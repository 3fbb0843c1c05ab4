"""The port's ResNet18 against the JAX package's, on the CPU at its full
widths, B = 8, F = 60, T = 32, embedding 16: ``bn_relu_train`` (values and
VJP), the weight map both ways, eval mode in f32, train mode with the JAX
model's own pooling noise injected (outputs, BN statistics, gradients),
and bf16 against the JAX model's bf16. The LCNN tests
(tests/test_torch_lcnn.py) share the helpers here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.interop.torch_port import port_resnet
from asvspoof2021_air_tpu.ops import bn_relu_vjp as jbn
from asvspoof2021_air_tpu.ops.bn_relu_vjp import bn_relu_train as j_bn_relu
from asvspoof2021_air_tpu_torch.interop.checkpoints import (
    resnet_from_state_dict)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables, random_flax_variables)
from asvspoof2021_air_tpu_torch.models.resnet import pooled_frames
from asvspoof2021_air_tpu_torch.ops import bn_relu_vjp as pbn
from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import bn_relu_train
from asvspoof2021_air_tpu_torch.utils import profiling
from test_torch_train_families import (
    B, ENC, family_input, family_variables, flax_name, given_draws,
    jax_model, port_draws, port_model, recorder, reversed_draw)
from torch_threads import one_thread  # noqa: F401

RUNNING = ("running_mean", "running_var")


def check_bn_vjp(j_fn, p_fn, seed: int, channels_last: bool = False) -> None:
    """y, mu, var and the three cotangents of a recompute-VJP BN over NCHW
    (channel dim 1), or with ``channels_last`` over NHWC (dim -1), against
    the JAX rule over NHWC, with nonzero cotangents on (mu, var) too; f32,
    1e-5."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((4, 6, 5, 7)).astype(np.float32)       # NCHW
    scale = (1 + 0.1 * g.standard_normal(6)).astype(np.float32)
    bias = (0.3 * g.standard_normal(6)).astype(np.float32)
    gy = g.standard_normal(x.shape).astype(np.float32)
    gmu, gvar = (g.standard_normal(6).astype(np.float32) for _ in range(2))
    nhwc = lambda a: np.ascontiguousarray(a.transpose(0, 2, 3, 1))
    (y, mu, var), pull = jax.vjp(lambda *a: j_fn(*a, 1e-5),
                                 jnp.asarray(nhwc(x)), jnp.asarray(scale),
                                 jnp.asarray(bias))
    want = pull((jnp.asarray(nhwc(gy)), jnp.asarray(gmu), jnp.asarray(gvar)))
    port = nhwc if channels_last else (lambda a: a)     # the port's layout
    back = (lambda a: a) if channels_last else nhwc     # port -> NHWC
    tx, ts, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (port(x), scale, bias))
    ty, tmu, tvar = p_fn(tx, ts, tb, 1e-5, -1 if channels_last else 1)
    torch.autograd.backward((ty, tmu, tvar), (
        torch.from_numpy(port(gy)), torch.from_numpy(gmu),
        torch.from_numpy(gvar)))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back(ty.detach().numpy()), np.asarray(y),
                               **tol)
    np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(mu), **tol)
    np.testing.assert_allclose(tvar.detach().numpy(), np.asarray(var), **tol)
    for name, got, w in (("dx", back(tx.grad.numpy()), want[0]),
                         ("dscale", ts.grad.numpy(), want[1]),
                         ("dbias", tb.grad.numpy(), want[2])):
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name, **tol)


def test_bn_relu_train_matches_jax():
    check_bn_vjp(j_bn_relu, bn_relu_train, 0)


# Each mode of the port's BNTrainVJP (the plain backward on the CPU, in the
# arithmetic of csrc/bn_bwd.cu) against its JAX rule.
BN_MODES = {
    "relu_bn": (jbn.relu_bn_train, pbn.relu_bn_train),
    "bn_relu": (jbn.bn_relu_train, pbn.bn_relu_train),
    "bn_leaky_relu": (
        lambda x, s, b, eps: jbn.bn_leaky_relu_train(x, s, b, eps, 0.1),
        lambda x, s, b, eps, dim: pbn.bn_leaky_relu_train(x, s, b, eps, 0.1,
                                                          dim)),
    "bn": (jbn.bn_train, pbn.bn_train),
}


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("mode", list(BN_MODES))
def test_bn_vjp_matches_jax_in_every_mode_and_layout(mode, channels_last):
    check_bn_vjp(*BN_MODES[mode], 10 + list(BN_MODES).index(mode),
                 channels_last)


def _bn_backward_args(x, gy):
    C = x.shape[1]
    res = tuple(torch.ones(C) for _ in range(5))
    return (x, gy, res, None, None, x.numel() // C, "bn_relu", 0.0, 1)


@pytest.mark.parametrize("fault", ["float64", "mixed_dtypes", "gy_shape",
                                   "cpu_tensors"])
def test_bn_backward_kernel_refuses_what_it_cannot_take(fault):
    """The kernel's wrapper raises, before any launch, on a type, a shape or
    a device it does not take; CPU tensors are refused last, so the first
    three are the checks a CUDA caller meets."""
    x = torch.randn(2, 3, 5)
    gy = {"float64": torch.randn(2, 3, 5, dtype=torch.float64),
          "mixed_dtypes": torch.randn(2, 3, 5, dtype=torch.bfloat16),
          "gy_shape": torch.randn(2, 3, 4),
          "cpu_tensors": torch.randn(2, 3, 5)}[fault]
    if fault == "float64":
        x = x.double()
    match = {"float64": "dtype", "mixed_dtypes": "dtype", "gy_shape": "shape",
             "cpu_tensors": "CUDA"}[fault]
    with pytest.raises(ValueError, match=match):
        pbn.bn_backward_kernel(*_bn_backward_args(x, gy))


def test_bn_backward_on_cpu_tensors_counts_no_kernel_launch():
    """On CPU tensors the backward is the plain version: the ``bn_bwd``
    counter stays 0 through a forward and backward of every mode."""
    profiling.reset()
    x = torch.randn(4, 6, 5, requires_grad=True)
    for mode, (_, p_fn) in BN_MODES.items():
        y, _, _ = p_fn(x, torch.ones(6), torch.zeros(6), 1e-5, 1)
        y.sum().backward()
    assert x.grad is not None
    assert profiling.counts().get("bn_bwd", 0) == 0


@pytest.mark.parametrize("shape", [
    (64, 512, 750, 2), (64, 64, 750, 2), (48000, 128, 1, 2),
    (64, 16, 13500, 4), (64, 128, 3375, 1), (64, 512, 282, 2),
    (64, 256, 94, 2), (3, 1, 7, 1), (2, 5, 1, 1), (9, 3, 282, 2)])
def test_bn_vjp_plan_covers_every_item_once(shape):
    """The grid of csrc/bn_bwd.cu for x viewed as (outer, C, inner) with
    vectors of ``vec`` elements on 132 SMs (the cells' shapes, ragged
    ones): at most MAX_SPLITS blocks a channel, none empty, together
    covering every piece of every row (channels last: every row) once, and
    a row's pieces covering its vectors."""
    outer, C, inner, vec = shape
    splits, pieces, per_block = pbn.bn_vjp_plan(outer, C, inner, vec, 132)
    items = outer * pieces
    assert 1 <= splits <= pbn.MAX_SPLITS
    assert (splits - 1) * per_block < items <= splits * per_block
    if inner == 1:
        assert pieces == 1
    else:
        sv = inner // vec
        lv = -(-sv // pieces)
        assert 1 <= pieces <= sv and lv * pieces >= sv and lv <= 512
        # about 64 warps an SM wherever the rows are long enough for it
        assert items * C >= min(64 * 132, C * outer * -(-sv // 64))


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _np(t):
    return t.detach().float().numpy()


def run_pair(family: str, T: int, seed: int, train: bool, dtype=None,
             with_grads: bool = False, reverse: bool = False):
    """The JAX model (fused_bn=True) and the port's on the same seeded
    weights and inputs (``family_variables``, ``family_input``):
    {quantity: (port, jax)} of the embedding, the logits and, in train
    mode, every BN running statistic after the forward (the port's names)
    and, ``with_grads``, every parameter gradient of sum emb^2 + sum
    logits^2 (a parameter the loss does not reach has a zero gradient).
    Train mode injects the JAX model's own draw, if it makes one.
    ``reverse`` runs both on the batch with its rows (and the draw's rows)
    reversed, which leaves the statistics and gradients unchanged in exact
    arithmetic."""
    g = np.random.default_rng(seed)
    x = family_input(family, g, T)
    v = family_variables(family, x, seed, T)
    if reverse:
        x = np.ascontiguousarray(x[::-1])
    jm = jax_model(family, T, jnp.bfloat16 if dtype else None)
    model = port_model(family, T, dtype)
    name = flax_name(family)
    sd = from_flax_variables(v, model=name)
    model.load_state_dict(sd)
    out = {}
    if not train:
        e, lg = jm.apply(v, jnp.asarray(x), False)
        model.eval()
        with torch.no_grad():
            pe, pl = model(torch.from_numpy(x))
        return {"emb": (_np(pe), e), "logits": (_np(pl), lg)}
    rng = jax.random.PRNGKey(seed + 100)
    draw = recorder(jm)(v, jnp.asarray(x), rng)
    if reverse and draw is not None:
        draw = reversed_draw(np.array(draw))

    def loss(params):
        if reverse and draw is not None:
            with given_draws(jnp.asarray(draw)):
                return forward(params)
        return forward(params)

    def forward(params):
        (e, lg), mut = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), True, mutable=["batch_stats"],
            rngs={"dropout": rng, "noise": jax.random.fold_in(rng, 1)})
        return jnp.sum(e.astype(jnp.float32) ** 2) + jnp.sum(
            lg.astype(jnp.float32) ** 2), (e, lg, mut)

    grads, (e, lg, mut) = jax.jit(jax.grad(loss, has_aux=True))(v["params"])
    model.train()
    draws = port_draws(family, None if draw is None else np.array(draw))
    pe, pl = model(torch.from_numpy(x),
                   *(() if draws is None else (draws,)))
    out = {"emb": (_np(pe), e), "logits": (_np(pl), lg)}
    want_sd = from_flax_variables(jax.tree.map(np.asarray, {
        "params": v["params"], "batch_stats": mut["batch_stats"]}),
        model=name)
    for k, t in model.state_dict().items():
        if k.endswith(RUNNING):
            out[k] = (_np(t), want_sd[k].numpy())
    if with_grads:
        (pe.pow(2).sum() + pl.pow(2).sum()).backward()
        want_g = from_flax_variables(jax.tree.map(np.asarray, {
            "params": grads, "batch_stats": v["batch_stats"]}),
            model=name)
        for n, p in model.named_parameters():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            out["grad " + n] = (_np(got), want_g[n].numpy())
    return out


def norm_err(got, want) -> float:
    """|got - want| over |want|, both as flat vectors (2-norms)."""
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def check_f32(pairs, bar: float = 1e-4, grad_bar: float = 1e-4,
              grad_norm_bar: float = None, spread: dict = None) -> None:
    """Each quantity within ``bar`` of its largest magnitude; gradients
    within ``grad_bar`` of their largest or, with ``grad_norm_bar``, each
    tensor's error within that fraction of its norm, or within 4
    ``spread[name]`` of it where ``spread`` gives a larger one; a quantity
    that is zero in JAX zero in the port."""
    for name, (got, want) in pairs.items():
        if not np.any(want):        # a parameter the loss does not reach
            assert not np.any(got), name
            continue
        if name.startswith("grad ") and grad_norm_bar is not None:
            err, limit = norm_err(got, want), grad_norm_bar
            if spread is not None:
                limit = max(limit, 4 * spread[name])
            assert err <= limit, (name, err, limit)
            continue
        limit = grad_bar if name.startswith("grad ") else bar
        assert rel_err(got, want) <= limit, (name, rel_err(got, want))


def check_bf16(family: str, T: int, seed: int, train: bool) -> None:
    """The port's bf16 model against the JAX model's bf16, each quantity
    relative to the f32 quantity's largest magnitude. The JAX bf16 model
    is ``own`` from its f32, measured here. A port whose bf16 is no
    further than ``own`` from f32 is within 2 own of the JAX bf16 (the
    triangle inequality; the two round their convs' sums in other orders,
    so their bf16 errors are nearly independent), and the bar is
    max(2 own, 1e-2). Read at these seeds: at most 1.98 own (a ResNet18
    running variance, 2.0e-5, under the floor); of the quantities over
    the floor only the ResNet18 train-mode embedding passes 1 own, at 1.53
    (2.93e-2 against own 1.91e-2). The port's bf16 must also be at least
    own / 4 from JAX's f32 (read: 0.72 own or more): a port that computed
    in f32 would sit within 4e-5 of it and fail there."""
    bf16 = run_pair(family, T, seed, train, torch.bfloat16)
    f32 = run_pair(family, T, seed, train)
    assert set(bf16) == set(f32)
    for name, (got, want) in bf16.items():
        ref = np.asarray(f32[name][1], np.float64)
        scale = np.abs(ref).max()
        got = np.asarray(got, np.float64)
        own = float(np.abs(np.asarray(want, np.float64) - ref).max()) / scale
        err = float(np.abs(got - np.asarray(want, np.float64)).max()) / scale
        assert err <= max(2 * own, 1e-2), (name, err, own)
        off_f32 = float(np.abs(got - ref).max()) / scale
        assert off_f32 >= own / 4, (name, off_f32, own)


def test_weight_map_inverts_port_resnet_and_matches_the_flax_tree():
    """``from_flax_variables`` is the inverse of the JAX package's
    ``port_resnet`` (bit for bit), the seeded tree has the JAX model's
    init names and shapes, and ``resnet_from_state_dict`` rebuilds the
    model from the weights alone."""
    v = random_flax_variables(0, model="resnet", enc_dim=ENC)
    sd = from_flax_variables(v, model="resnet")
    back = port_resnet({k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    a, b = flat(v), flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    init = jax.eval_shape(lambda: jax_model("resnet", 32).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 60)), False))
    assert {k: x.shape for k, x in a.items()} == {
        jax.tree_util.keystr(p): tuple(x.shape) for p, x in
        jax.tree_util.tree_flatten_with_path(init)[0]}
    model = resnet_from_state_dict(sd, device="cpu")
    assert not model.training and model.fc.out_features == ENC
    assert set(model.state_dict()) == set(sd)
    assert "layer2.0.shortcut.0.weight" in sd
    assert "layer2.1.shortcut.0.weight" not in sd


def test_resnet_eval_matches_jax():
    """Embedding and logits in f32, 1e-4 of the largest magnitude."""
    check_f32(run_pair("resnet", 32, 1, train=False))


def test_resnet_train_mode_matches_jax_with_its_noise():
    """Train mode, JAX's pooling noise injected: embedding, logits and the
    BN running statistics after the forward within 1e-4 of their largest
    magnitude; every parameter gradient of sum emb^2 + sum logits^2
    within max(5e-3, 4 (s_jax + s_port)) of its norm, s being each
    package's own spread: its gradient against its gradient of the same
    batch and noise with the rows reversed, which are equal in exact
    arithmetic (the bar of tests/test_torch_res2net.py). On one host
    bn1.weight's gradient read 7.6e-3 of its norm from JAX's against the
    old 5e-3. Not per element: a pre-activation ReLU whose input the two
    packages round to opposite sides of zero moves single elements of the
    first stages' gradients, up to 1.1e-2 of a tensor's largest here (the
    JAX model's jitted and eager gradients differ so too), where one
    wrong term of the backward moves a whole tensor."""
    pairs = run_pair("resnet", 32, 2, train=True, with_grads=True)
    rev = run_pair("resnet", 32, 2, train=True, with_grads=True,
                   reverse=True)
    assert sum(k.endswith(RUNNING) for k in pairs) == 2 * 18
    assert sum(k.startswith("grad ") for k in pairs) == 63
    spread = {n: norm_err(rev[n][1], want) + norm_err(rev[n][0], got)
              for n, (got, want) in pairs.items()
              if n.startswith("grad ") and np.any(want)}
    check_f32(pairs, grad_norm_bar=5e-3, spread=spread)
    assert pooled_frames(32) == 4 and pooled_frames(750) == 94


@pytest.mark.parametrize("train", [False, True])
def test_resnet_bf16_matches_jax_bf16(train):
    check_bf16("resnet", 32, 3, train)
