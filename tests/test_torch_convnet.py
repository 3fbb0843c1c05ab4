"""The port's ConvNet and Subband against the JAX package's, on the CPU:
``bn_leaky_relu_train`` (values and VJP), ConvNet in both variants (the
flattened head the registry builds, and ``subband_attention`` with JAX's
own pooling noise recorded and injected) in eval and train mode, the
weight maps both ways (the head's NHWC flatten permuted), Subband with 2
bands (JAX's dropout masks per band injected), a 4-step ConvNet
trajectory against the JAX step, ``train()`` from feature files, the f32
compute of SE-Res2Net50, ConvNet and RawNet2 under
``compute_dtype="bfloat16"``, and ``cli.generate_score`` over a ConvNet
run against the JAX CLI."""

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
from asvspoof2021_air_tpu.interop.torch_port import port_convnet, port_subband
from asvspoof2021_air_tpu.models.convnet import ConvNet as JConvNet
from asvspoof2021_air_tpu.models.registry import build_model as j_build
from asvspoof2021_air_tpu.models.subband import Subband as JSubband
from asvspoof2021_air_tpu.ops.bn_relu_vjp import (
    bn_leaky_relu_train as j_bn_leaky)
from asvspoof2021_air_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from asvspoof2021_air_tpu_torch.cli import generate_score as p_cli
from asvspoof2021_air_tpu_torch.interop.checkpoints import (
    convnet_from_state_dict)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables)
from asvspoof2021_air_tpu_torch.models.convnet import convnet_extent
from asvspoof2021_air_tpu_torch.models.registry import build_model
from asvspoof2021_air_tpu_torch.models.subband import Subband
from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import bn_leaky_relu_train
from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import (
    TrainConfig, setup_training, train)
from test_torch_resnet import check_bn_vjp, check_f32, rel_err, run_pair
from test_torch_scoring import (
    assert_same_score_files, feature_trees, shared_jax_make_score_fn)
from test_torch_train_families import (  # noqa: F401  (the fixture)
    B, ENC, FRAMES, RAWNET_TINY, _fast_jax_init, _two_threads,
    _write_features, check_trajectory, family_input, family_variables,
    port_draws, recorder, trajectory)

RUNNING = ("running_mean", "running_var")


def _tree(a):
    return jax.tree.map(np.asarray, a)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_bn_leaky_relu_train_matches_jax():
    """y, mu, var and the cotangents of x, scale and bias, with nonzero
    cotangents on (mu, var), against the JAX rule at slope 0.1; 1e-5."""
    check_bn_vjp(lambda x, s, b, eps: j_bn_leaky(x, s, b, eps, 0.1),
                 lambda x, s, b, eps, dim: bn_leaky_relu_train(
                     x, s, b, eps, 0.1, dim), 4)


@pytest.mark.parametrize("family", ["cnn", "cnn_att"])
def test_convnet_eval_matches_jax(family):
    """Embedding and logits in f32, 1e-4 of the largest magnitude (read:
    7.8e-7)."""
    check_f32(run_pair(family, FRAMES[family], 1, train=False))


@pytest.mark.parametrize("family", ["cnn", "cnn_att"])
def test_convnet_train_mode_matches_jax(family):
    """Train mode (``subband_attention``: JAX's pooling noise injected):
    embedding, logits and BN statistics after the forward within 1e-4 of
    their largest magnitude; every parameter gradient of sum emb^2 + sum
    logits^2 within 5e-3 of its norm (read: 4.3e-6 at most)."""
    pairs = run_pair(family, FRAMES[family], 2, train=True, with_grads=True)
    n_layers = 5 if family == "cnn_att" else 4
    assert sum(k.endswith(RUNNING) for k in pairs) == 2 * n_layers
    check_f32(pairs, grad_norm_bar=5e-3)


@pytest.mark.parametrize("family", ["cnn", "cnn_att"])
def test_weight_map_inverts_port_convnet(family):
    """``from_flax_variables`` is the inverse of the JAX package's
    ``port_convnet`` bit for bit (its ``flatten_hw`` the 6 x 6 maps that
    32 frames of 60-dim features leave after layer 4); the port's names
    are the reference's; ``convnet_from_state_dict`` rebuilds the model.
    At 750 frames ``fc1`` is 47232 -> 256, the JAX model's (47232, 256)
    kernel."""
    T = FRAMES[family]
    x = family_input(family, np.random.default_rng(0), T)
    v = family_variables(family, x, 0, T)
    sd = from_flax_variables(v, model="cnn")
    att = family == "cnn_att"
    back = port_convnet({k: t.numpy() for k, t in sd.items()},
                        subband_attention=att,
                        flatten_hw=None if att else convnet_extent(60, T))
    a, b = _flat(v), _flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = convnet_from_state_dict(sd, device="cpu")
    assert set(model.state_dict()) == set(sd) and not model.training
    assert ("attention.att_weights" in sd) == att
    assert ("fc1.weight" in sd) == (not att)
    assert convnet_extent(60, 750) == (6, 123)
    full = build_model("cnn", device="cpu")
    assert tuple(full.fc1.weight.shape) == (256, 47232)
    shapes = jax.eval_shape(lambda: JConvNet(enc_dim=256).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 750, 60)), False))
    assert shapes["params"]["Dense_0"]["kernel"].shape == (47232, 256)


def _subband_pair(train: bool):
    T = FRAMES["lcnn"]
    g = np.random.default_rng(7)
    x = g.standard_normal((B, T, 60)).astype(np.float32)
    jm = JSubband(num_nodes=60, enc_dim=ENC, subband_num=2)
    v = _tree(jax.jit(lambda k: jm.init(k, jnp.asarray(x), False))(
        jax.random.PRNGKey(3)))
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + 0.05 * g.random(a.shape)).astype(np.float32),
        v["batch_stats"])
    model = Subband(num_nodes=60, enc_dim=ENC, subband_num=2, feat_len=T,
                    device="cpu")
    sd = from_flax_variables(v, model="subband", num_nodes=60)
    model.load_state_dict(sd)
    if not train:
        model.eval()
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        want = jax.jit(jm.apply, static_argnums=2)(v, jnp.asarray(x), False)
        return v, sd, got, want, None
    rng = jax.random.PRNGKey(11)
    draws = recorder(jm)(v, jnp.asarray(x), rng)
    want, _mut = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"],
                          rngs={"dropout": rng,
                                "noise": jax.random.fold_in(rng, 1)})
    model.train()
    got = model(torch.from_numpy(x),
                [port_draws("lcnn", np.array(d), rows=1) for d in draws])
    return v, sd, got, want, draws


@pytest.mark.parametrize("train", [False, True])
def test_subband_matches_jax(train):
    """Subband of 2 bands of 30 rows (embeddings 8 + 8), as
    tests/test_models.py builds it at 60-dim features: the band embeddings
    in eval mode and, with JAX's dropout mask for each band injected, in
    train mode, 1e-4 of the largest; the weight map inverts
    ``port_subband`` bit for bit (``sub1.*``, ``sub2.*``)."""
    v, sd, got, want, draws = _subband_pair(train)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape == (B, ENC // 2)
        assert rel_err(a.detach().numpy(), b) <= 1e-4
    if train:
        assert len(draws) == 2 and draws[0].shape == (B, 32 * 1 * 3)
        return
    back = port_subband({k: t.numpy() for k, t in sd.items()},
                        band_nodes=30, feat_len=FRAMES["lcnn"],
                        subband_num=2)
    a, b = _flat(v), _flat(back)
    assert set(a) == set(b) and all(k.startswith("['") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert {k.split(".")[0] for k in sd} == {"sub1", "sub2"}


def test_convnet_trajectory_tracks_jax():
    """ConvNet + ang_iso, 4 steps from one mid-training state, by
    ``check_trajectory``'s bars; it draws nothing (no attention)."""
    t = trajectory("cnn", "ang_iso")
    check_trajectory(t, "ang_iso")
    assert all(d is None for d in t["draws"])


def test_train_convnet_from_feature_files(tmp_path):
    """Two epochs of ``train()`` of ConvNet + iso_sq from feature files at
    ``compute_dtype="bfloat16"`` (f32 all the same, as in JAX), two steps
    a call: the logs, the summary, BN statistics and the center moved."""
    T = FRAMES["cnn"]
    ori = str(tmp_path / "ori")
    _write_features(ori, "train", 16, 0, T)
    _write_features(ori, "dev", 8, 1, T)
    cfg = TrainConfig(out_fold=str(tmp_path / "out"), path_to_features=ori,
                      model="cnn", add_loss="iso_sq", batch_size=B,
                      feat_len=T, enc_dim=ENC, num_epochs=2,
                      compute_dtype="bfloat16", steps_per_call=2)
    init = setup_training(cfg, 2, device="cpu")[2].state_dict()
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    assert state.step == 4
    live = state.state_dict()
    assert all(v.dtype == torch.float32 for v in live["model"].values())
    assert all(not torch.equal(live["model"][n], init["model"][n])
               for n in live["model"] if n.endswith("running_var"))
    assert not torch.equal(live["loss_module"]["center"],
                           init["loss_module"]["center"])
@pytest.mark.parametrize("family", ["res2net", "cnn", "rawnet"])
def test_families_stay_f32_under_bfloat16(family):
    """The JAX registry builds SE-Res2Net50, ConvNet and RawNet2 without a
    compute dtype, so under ``compute_dtype="bfloat16"`` they compute in
    f32: the port's parameters and every module's output are f32 in a
    train-mode forward of the model ``setup_training`` builds, as the JAX
    registry's model's outputs are."""
    cfg = TrainConfig(model=family, compute_dtype="bfloat16",
                      feat_len=32, on_the_fly=family == "rawnet",
                      rawnet_args=RAWNET_TINY)
    model = setup_training(cfg, 1, device="cpu")[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    dtypes = set()
    hooks = [m.register_forward_hook(
        lambda m, i, o: dtypes.update(t.dtype for t in (
            o if isinstance(o, tuple) else (o,)) if torch.is_tensor(t)))
        for m in model.modules()]
    x = family_input(family, np.random.default_rng(2), 32)
    model.train()(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert dtypes == {torch.float32}
    jm = j_build(family, dtype=jnp.bfloat16, rawnet_args=RAWNET_TINY)
    out = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.asarray(x), False)[0])
    assert all(o.dtype == jnp.float32 for o in out)


def test_generate_score_cli_convnet_matches_jax_cli(tmp_path, monkeypatch):
    """A port ConvNet + ang_iso run folder (feat_len 50), scored by the
    port's CLI on the CPU, against the JAX CLI over a JAX run folder of
    the same weights and center (atol 1e-4)."""
    paths = feature_trees(tmp_path / "feats")
    monkeypatch.setattr(jscoring, "make_score_fn", shared_jax_make_score_fn)
    _fast_jax_init(monkeypatch)
    x = family_input("cnn", np.random.default_rng(5), 50)
    variables = family_variables("cnn", x, 5, 50)
    center = np.random.default_rng(6).standard_normal((1, ENC)).astype(
        np.float32)
    common = dict(model="cnn", add_loss="ang_iso", enc_dim=ENC, feat_len=50)
    port = str(tmp_path / "runs" / "port")
    cfg = TrainConfig(out_fold=port, **common)
    state = setup_training(cfg, 1, device="cpu")[2]
    state.model.load_state_dict(from_flax_variables(variables, model="cnn"))
    with torch.no_grad():
        state.loss_module.center.copy_(torch.from_numpy(center))
    os.makedirs(port)
    with open(os.path.join(port, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    save_checkpoint(os.path.join(port, "best.pt"), state)

    jrun = str(tmp_path / "runs" / "jax")
    jcfg = jloop.TrainConfig(out_fold=jrun, **common)
    jst = jloop.setup_training(jcfg, steps_per_epoch=1)[2]
    jst = jst.replace(params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      loss_params={"center": center})
    os.makedirs(jrun)
    with open(os.path.join(jrun, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    j_save_checkpoint(os.path.join(jrun, "best"), jst)

    monkeypatch.chdir(tmp_path)
    args = ["--model_folder", str(tmp_path / "runs"), "-t", "19dev",
            "--batch_size", "4", "--ori_features", paths["ori_features"]]
    j_cli.main(["-n", "jax", *args])
    got = p_cli.main(["-n", "port", "--device", "cpu", *args])
    assert_same_score_files(got, tmp_path / "scores" / "jax_19dev_score.txt",
                            6)
