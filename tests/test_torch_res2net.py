"""The port's SE-Res2Net50 against the JAX package's, on the CPU: one
``SEBottle2neck`` at stride 1 ("normal") and stride 2 ("stage", at odd
extents, so the ceil-mode pool of the downsample averages partial
windows), the whole model at its fixed widths on B = 8 utterances of 24
frames of 60-dim features in eval and train mode, the weight map both
ways, and ``train()`` from feature files. The trajectory against the JAX
step is tests/test_torch_res2net_train.py. The JAX models run with
``fused_bn=True``, as the port always trains."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asvspoof2021_air_tpu.cli.generate_score as j_cli
import asvspoof2021_air_tpu.scoring as jscoring
import asvspoof2021_air_tpu.train.loop as jloop
from asvspoof2021_air_tpu.interop.torch_port import port_se_res2net50
from asvspoof2021_air_tpu.models.registry import build_model as j_build
from asvspoof2021_air_tpu.models.res2net import SEBottle2neck as JBlock
from asvspoof2021_air_tpu.models.summary import parameter_table
from asvspoof2021_air_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from asvspoof2021_air_tpu_torch.cli import generate_score as p_cli
from asvspoof2021_air_tpu_torch.interop.checkpoints import (
    res2net_from_state_dict)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables, res2net_block_from_flax)
from asvspoof2021_air_tpu_torch.models.res2net import SEBottle2neck
from asvspoof2021_air_tpu_torch.models.summary import summarize
from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import (
    TrainConfig, setup_training, train)
from test_torch_resnet import check_f32, norm_err, rel_err
from test_torch_scoring import (
    assert_same_score_files, feature_trees, shared_jax_make_score_fn)
from test_torch_train_families import (  # noqa: F401  (the fixture)
    B, ENC, RAWNET_TINY, _fast_jax_init, _two_threads, _write_features,
    check_trajectory, family_input, family_variables, jax_model, port_model,
    trajectory)

T = 24
RUNNING = ("running_mean", "running_var")


def _np(t):
    return t.detach().float().numpy()


def _tree(a):
    return jax.tree.map(np.asarray, a)


@pytest.mark.parametrize("stride,stype,cin,hw", [
    (1, "normal", 32, (8, 10)), (2, "stage", 24, (7, 9))])
def test_bottleneck_matches_jax(stride, stype, cin, hw):
    """One SE bottleneck of planes 16 (width 6, scale 4): eval output,
    train output and BN statistics 1e-4 of their largest; the gradients of
    sum out^2 for the parameters and the input within 5e-3 of each
    tensor's norm (read: 5.7e-7 at most). The stage block pools the last
    group 3x3 with padding 1 counted (flax's avg_pool) and downsamples the
    7 x 9 input in ceil mode to 4 x 5 over the valid windows only."""
    g = np.random.default_rng(0)
    x = g.standard_normal((4, cin, *hw)).astype(np.float32)     # NCHW
    nhwc = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, -1))
    jb = JBlock(16, stride, stype=stype, fused_bn=True)
    v = _tree(jb.init(jax.random.PRNGKey(1), jnp.asarray(nhwc(x)), False))
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + 0.05 * g.random(a.shape)).astype(np.float32),
        v["batch_stats"])
    pb = SEBottle2neck(cin, 16, stride, stype=stype)
    pb.load_state_dict(res2net_block_from_flax(v))
    assert (pb.downsample is not None) == (stride != 1)
    pb.eval()
    with torch.no_grad():
        got = pb(torch.from_numpy(x))
    want = jax.jit(jb.apply, static_argnums=2)(v, jnp.asarray(nhwc(x)),
                                                False)
    assert got.shape == (4, 32, *((4, 5) if stride == 2 else hw))
    assert rel_err(nhwc(_np(got)), want) <= 1e-4

    def loss(params, xx):
        out, mut = jb.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx, True,
                            mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mut["batch_stats"])

    (gp, gx), (out, stats) = jax.jit(jax.grad(loss, (0, 1), has_aux=True))(
        v["params"], jnp.asarray(nhwc(x)))
    pb.train()
    tx = torch.from_numpy(x).requires_grad_()
    pout = pb(tx)
    pout.pow(2).sum().backward()
    assert rel_err(nhwc(_np(pout)), out) <= 1e-4
    want_sd = res2net_block_from_flax({"params": _tree(v["params"]),
                                       "batch_stats": _tree(stats)})
    want_g = res2net_block_from_flax({"params": _tree(gp),
                                      "batch_stats": _tree(stats)})
    for k, t in pb.state_dict().items():
        if k.endswith(RUNNING):
            assert rel_err(_np(t), want_sd[k].numpy()) <= 1e-4, k
    for n, p in pb.named_parameters():
        assert norm_err(_np(p.grad), want_g[n].numpy()) <= 5e-3, n
    assert norm_err(nhwc(_np(tx.grad)), gx) <= 5e-3


def test_weight_map_inverts_port_se_res2net50():
    """``from_flax_variables`` is the inverse of the JAX package's
    ``port_se_res2net50`` bit for bit, the port's model has exactly the
    reference's names (``conv1.{0,3,6}``, ``layer{1..4}.{b}.{conv1, bn1,
    convs.j, bns.j, conv3, bn3, se.fc.{0,2}, downsample.{1,2}}``,
    ``cls_layer``), and ``res2net_from_state_dict`` rebuilds it."""
    x = family_input("res2net", np.random.default_rng(0), T)
    v = family_variables("res2net", x, 0, T)
    sd = from_flax_variables(v, model="res2net")
    back = port_se_res2net50({k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    a, b = flat(v), flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = res2net_from_state_dict(sd, device="cpu")
    assert not model.training and set(model.state_dict()) == set(sd)
    for name in ("conv1.6.weight", "conv1.4.running_var",
                 "layer1.0.downsample.1.weight", "layer3.5.convs.2.weight",
                 "layer4.2.se.fc.2.weight", "cls_layer.bias"):
        assert name in sd, name
    assert "layer1.1.downsample.1.weight" not in sd


def test_res2net_eval_matches_jax():
    """Embedding and log-probabilities in f32, 1e-4 of the largest
    magnitude (read: 4.9e-7)."""
    x = family_input("res2net", np.random.default_rng(1), T)
    v = family_variables("res2net", x, 1, T)
    model = port_model("res2net", T).eval()
    model.load_state_dict(from_flax_variables(v, model="res2net"))
    with torch.no_grad():
        pe, pl = model(torch.from_numpy(x))
    e, lg = jax.jit(jax_model("res2net", T).apply, static_argnums=2)(
        v, jnp.asarray(x), False)
    check_f32({"emb": (_np(pe), e), "logits": (_np(pl), lg)})


def test_res2net_train_mode_matches_jax():
    """Train mode: embedding, log-probabilities and every BN running
    statistic after the forward within 1e-4 of their largest magnitude
    (read: 3.0e-5, 5.2e-5). Gradients of sum emb^2 + sum logp^2 per tensor
    within max(5e-3, 4 (s_jax + s_port)) of its norm, where s is each
    package's own spread: its gradient against its gradient of the same
    batch in reverse order, which are equal in exact arithmetic. The
    bar of 5e-3 does not hold between two f32 computations of this
    model: the port's f32 gradients are 1.7e-2 of a tensor's norm from the
    port's float64 at this seed, JAX's 3.2e-2 (its f32 batch statistics
    sit 5-20x further from float64's than the port's), as ReLU inputs
    rounded to the other side of zero move whole channels through the
    batch norms of the late stages (192 elements a channel in layer4).
    Read here: error 2.3e-2 at most; at seeds 1-3 (the third at 16 x 24
    features) the error reached at most half of its bar, and either
    package's own spread up to 6.2e-2."""
    x = family_input("res2net", np.random.default_rng(1), T)
    v = family_variables("res2net", x, 1, T)
    jm = jax_model("res2net", T)
    sd = from_flax_variables(v, model="res2net")

    def loss(params, xx):
        (e, lg), mut = jm.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, xx, True,
                                mutable=["batch_stats"])
        return jnp.sum(e ** 2) + jnp.sum(lg ** 2), (e, lg, mut)

    grad = jax.jit(jax.grad(loss, has_aux=True))
    runs = []
    for xx in (x, x[::-1].copy()):
        gp, (e, lg, mut) = grad(v["params"], jnp.asarray(xx))
        jg = from_flax_variables(_tree({"params": gp, "batch_stats":
                                        v["batch_stats"]}), model="res2net")
        js = from_flax_variables(_tree({"params": v["params"],
                                        "batch_stats": mut["batch_stats"]}),
                                 model="res2net")
        model = port_model("res2net", T).train()
        model.load_state_dict(sd)
        pe, pl = model(torch.from_numpy(xx))
        (pe.pow(2).sum() + pl.pow(2).sum()).backward()
        runs.append(dict(e=(_np(pe), e), lg=(_np(pl), lg), jg=jg, js=js,
                         pg={n: p.grad for n, p in model.named_parameters()},
                         ps=model.state_dict()))
    r, rev = runs
    check_f32({"emb": r["e"], "logits": r["lg"]})
    stats = [k for k in r["ps"] if k.endswith(RUNNING)]
    assert len(stats) == 2 * 87
    for k in stats:
        assert rel_err(_np(r["ps"][k]), r["js"][k].numpy()) <= 1e-4, k
    assert len(r["pg"]) == 295
    for n, pg in r["pg"].items():
        err = norm_err(_np(pg), r["jg"][n].numpy())
        s_jax = norm_err(rev["jg"][n].numpy(), r["jg"][n].numpy())
        s_port = norm_err(_np(rev["pg"][n]), _np(pg))
        assert err <= max(5e-3, 4 * (s_jax + s_port)), (n, err, s_jax,
                                                        s_port)


def test_train_res2net_from_feature_files(tmp_path):
    """Two epochs of ``train()`` of SE-Res2Net50 + isolate from feature
    files, two steps a call (a loop on the CPU): the logs, the summary, BN
    statistics and the center moved."""
    ori = str(tmp_path / "ori")
    _write_features(ori, "train", 16, 0, T)
    _write_features(ori, "dev", 8, 1, T)
    cfg = TrainConfig(out_fold=str(tmp_path / "out"), path_to_features=ori,
                      model="res2net", add_loss="isolate", batch_size=B,
                      feat_len=T, num_epochs=2, steps_per_call=2)
    init = setup_training(cfg, 2, device="cpu")[2].state_dict()
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    assert state.step == 4
    live = state.state_dict()
    assert all(not torch.equal(live["model"][n], init["model"][n])
               for n in live["model"] if n.endswith("running_var"))
    assert not torch.equal(live["loss_module"]["center"],
                           init["loss_module"]["center"])
