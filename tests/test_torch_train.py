"""The port's training slice against the JAX package, on the CPU at small
shapes: relu_bn_train and the train-mode BatchNorm rule, ECAPA in train
mode (outputs, BN statistics, gradients), a 4-step ang_iso trajectory from
one mid-training state, and train() end to end on a wav corpus.

The JAX side runs ECAPA with fused_pool=True (its Pallas VJP in interpret
mode) and fused_bn=True, the configuration its TPU training uses."""

import ast
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asvspoof2021_air_tpu.train.loop as jloop
from asvspoof2021_air_tpu.losses import build_loss
from asvspoof2021_air_tpu.models.common import BatchNorm as JBatchNorm
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.ops.bn_relu_vjp import relu_bn_train as j_relu_bn
from asvspoof2021_air_tpu.train import state as jstate
from asvspoof2021_air_tpu.train.steps import StepConfig as JStepConfig
from asvspoof2021_air_tpu.train.steps import make_train_step as j_make_step
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.cli.train import config_from_args
from asvspoof2021_air_tpu_torch.cli.train import main as cli_main
from asvspoof2021_air_tpu_torch.cli.train import parse_args as cli_parse_args
from asvspoof2021_air_tpu_torch.data.audio_io import write_wav
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_train_state, from_flax_variables)
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.models.common import BatchNorm1d
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import relu_bn_train
from asvspoof2021_air_tpu_torch.train.checkpoint import restore_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import (
    TrainConfig, check_supported, setup_training, train)
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import StepConfig, make_train_step
from torch_threads import one_thread  # noqa: F401

# Small ECAPA: C=32, scale 4, embedding 16. Batch 8, not 2: train-mode BN
# over a 2-sample batch has near-zero variances that amplify sum-order
# noise by ~1/sqrt(eps) (tests/test_attn_pool_vjp.py:91-96).
C, SCALE, ENC, B, T = 32, 4, 16, 8, 40
LR = 5e-4

disable_tf32()


def _jmodel(fused_chain: bool = False, fused: bool = True):
    """The JAX model with fused_pool and fused_bn both ``fused``."""
    return JECAPA(C=C, model_scale=SCALE, n_out=2, n_feat=60, enc_dim=ENC,
                  fused_pool=fused, pool_interpret=fused, fused_bn=fused,
                  fused_chain=fused_chain)


def _port_model(fused_chain: bool = False, fused: bool = True):
    return ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, fused_pool=fused,
                      fused_bn=fused, device="cpu", fused_chain=fused_chain)


def _params_only(sd):
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("channels_last", [True, False])
def test_relu_bn_train_matches_jax(channels_last):
    """y, mu, var and all three cotangents, with nonzero cotangents on
    (mu, var) too so the analytic stat terms are pinned; f32, 1e-5."""
    g = np.random.default_rng(0)
    x = g.standard_normal((4, 12, 24)).astype(np.float32)
    scale = (1 + 0.1 * g.standard_normal(24)).astype(np.float32)
    bias = (0.1 * g.standard_normal(24)).astype(np.float32)
    gy = g.standard_normal(x.shape).astype(np.float32)
    gmu, gvar = (g.standard_normal(24).astype(np.float32) for _ in range(2))
    (y, mu, var), pull = jax.vjp(lambda *a: j_relu_bn(*a, 1e-5),
                                 *map(jnp.asarray, (x, scale, bias)))
    want = pull((jnp.asarray(gy), jnp.asarray(gmu), jnp.asarray(gvar)))

    perm = (0, 1, 2) if channels_last else (0, 2, 1)
    tx = torch.from_numpy(x.transpose(perm).copy()).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    ty, tmu, tvar = relu_bn_train(tx, ts, tb, 1e-5,
                                  dim=-1 if channels_last else 1)
    torch.autograd.backward(
        (ty, tmu, tvar),
        (torch.from_numpy(gy.transpose(perm).copy()), torch.from_numpy(gmu),
         torch.from_numpy(gvar)))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty.detach().numpy().transpose(perm),
                               np.asarray(y), **tol)
    np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(mu), **tol)
    np.testing.assert_allclose(tvar.detach().numpy(), np.asarray(var), **tol)
    for name, got, w in (("dx", tx.grad.numpy().transpose(perm), want[0]),
                         ("dscale", ts.grad.numpy(), want[1]),
                         ("dbias", tb.grad.numpy(), want[2])):
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_train_batchnorm_running_stats_follow_jax_rule(fuse_relu):
    """The output and the running statistics of one train-mode step, from
    non-trivial statistics, against the JAX BatchNorm (biased variance,
    0.9 ra + 0.1 batch), 1e-6; torch.nn.BatchNorm1d's unbiased update
    would miss by var / (N - 1)."""
    g = np.random.default_rng(1)
    x = (2 + 3 * g.standard_normal((6, 10, 16))).astype(np.float32)
    p = {"scale": (1 + 0.1 * g.standard_normal(16)).astype(np.float32),
         "bias": (0.1 * g.standard_normal(16)).astype(np.float32)}
    s = {"mean": g.standard_normal(16).astype(np.float32),
         "var": (1 + g.random(16)).astype(np.float32)}
    y, mut = JBatchNorm(use_running_average=False, fuse_relu=fuse_relu).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x),
        mutable=["batch_stats"])
    bn = BatchNorm1d(16).train()
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})
    xt = torch.from_numpy(x)
    got = bn.relu_bn(xt, dim=-1) if fuse_relu else bn(xt, dim=-1)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), **tol)
    r = np.maximum(x, 0) if fuse_relu else x
    unbiased = 0.9 * s["var"] + 0.1 * r.reshape(-1, 16).var(0, ddof=1)
    assert np.abs(bn.running_var.numpy() - unbiased).max() > 1e-3


def test_ecapa_train_mode_matches_jax():
    """Embedding and logits (5e-4), the updated batch statistics (rtol
    1e-4 / atol 1e-5) and every parameter gradient of sum emb^2 + sum
    logits^2 (rtol 5e-3, atol 2e-4 times max(1, the tensor's largest
    |gradient|)): the JAX test's bars for its fused train-mode model
    (tests/test_attn_pool_vjp.py:85-142), with atol scaled. There both
    sides share every conv; here they do not, and the stem conv's
    gradients reach ~77, where the plain atol 2e-4 is the f32 noise floor.
    Against the plain bar the port's worst element is 1.13x it
    (conv1.weight), where the JAX package's own eager and jitted gradients
    differ by 0.85x it; with the scaled atol the port's worst is 0.05x
    (tests/torch_ecapa_grad_floor.py prints these readings)."""
    check_ecapa_train_mode()


def check_ecapa_train_mode(fused: bool = True) -> None:
    """The checks of ``test_ecapa_train_mode_matches_jax`` with
    fused_pool and fused_bn both ``fused`` in each package. The fused
    pooling's Function gives ``attention.3``'s bias an exact zero
    gradient; the unfused softmax over T gives it rounding noise, held
    by the gradients' atol."""
    feats = np.random.default_rng(11).standard_normal((B, T, 60)).astype(
        np.float32)
    model = _jmodel(fused=fused)
    v = jax.tree.map(np.asarray, model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(feats), False))

    @jax.jit
    def fwd_grad(params):
        def loss(p):
            (e, lg), mut = model.apply(
                {"params": p, "batch_stats": v["batch_stats"]},
                jnp.asarray(feats), True, mutable=["batch_stats"])
            return jnp.sum(e ** 2) + jnp.sum(lg ** 2), (e, lg, mut)
        return jax.grad(loss, has_aux=True)(params)

    grads, (emb, logits, mut) = fwd_grad(v["params"])
    port = _port_model(fused=fused).train()
    port.load_state_dict(from_flax_variables(v, SCALE))
    pe, pl = port(torch.from_numpy(feats))
    (pe.pow(2).sum() + pl.pow(2).sum()).backward()
    for got, want in ((pe, emb), (pl, logits)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4)
    want_sd = from_flax_variables(jax.tree.map(np.asarray, {
        "params": v["params"], "batch_stats": mut["batch_stats"]}), SCALE)
    got_sd = port.state_dict()
    for k in want_sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    want_g = _params_only(from_flax_variables(jax.tree.map(np.asarray, {
        "params": grads, "batch_stats": v["batch_stats"]}), SCALE))
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want_g)
    for n, p in port.named_parameters():
        w = want_g[n].numpy()
        atol = 2e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=5e-3, atol=atol,
                                   err_msg=n)
    if fused:
        assert torch.all(port.attention[3].bias.grad == 0.0)


WARM, K = 2, 4


@pytest.fixture(scope="module")
def trajectory():
    return ecapa_trajectory()


def ecapa_trajectory(remat_policy=None, fused_chain: bool = False,
                     fused: bool = True):
    """WARM JAX steps from init (so the Adam moments and the count are
    non-trivial), the state carried across by from_flax_train_state, then
    K steps in each package on the same batches. The learning rate halves
    every 2 steps (steps_per_epoch 2, interval 1), so the schedule changes
    inside the K steps. ``remat_policy`` and ``fused_chain`` are set in
    both packages' K steps (the JAX step's and model's switches), and so
    are fused_pool and fused_bn (``fused``), the warm steps too."""
    g = np.random.default_rng(0)
    labels = (np.arange(B) % 2).astype(np.int32)
    feats = g.standard_normal((WARM + K, B, T, 60)).astype(np.float32)
    feats += 0.5 * labels[None, :, None, None]
    model = _jmodel(fused=fused)
    loss_mod = build_loss("ang_iso", enc_dim=ENC, r_real=0.9, r_fake=0.2,
                          alpha=20.0)
    sched = jstate.step_decay_schedule(LR, 0.5, 1, 2)
    btx = jstate.make_backbone_optimizer(sched)
    ltx = jstate.make_loss_optimizer(sched)
    state = jstate.create_train_state(
        jax.random.PRNGKey(0), model, jnp.asarray(feats[0]),
        loss_module=loss_mod, example_feat=jnp.zeros((B, ENC)),
        example_labels=jnp.asarray(labels), backbone_tx=btx, loss_tx=ltx)
    step = jax.jit(j_make_step(model, loss_mod, btx, ltx,
                               JStepConfig(add_loss="ang_iso")))
    batch = lambda s: {"feat": jnp.asarray(feats[s]),
                       "label": jnp.asarray(labels)}
    key = jax.random.PRNGKey(1)
    for s in range(WARM):
        state, _ = step(state, batch(s), key)
    start = from_flax_train_state(jax.device_get(state), SCALE)
    if remat_policy is not None or fused_chain:
        model = _jmodel(fused_chain, fused)
        step = jax.jit(j_make_step(model, loss_mod, btx, ltx, JStepConfig(
            add_loss="ang_iso", remat_policy=remat_policy)))
    j_losses = []
    for s in range(WARM, WARM + K):
        state, metrics = step(state, batch(s), key)
        j_losses.append(float(metrics["ang_iso"]))
    end = from_flax_train_state(jax.device_get(state), SCALE)

    pstate = create_train_state(
        _port_model(fused_chain, fused), OCSoftmax(
            feat_dim=ENC, r_real=0.9, r_fake=0.2, alpha=20.0, device="cpu"),
        step_decay_schedule(LR, 0.5, 1, 2))
    pstate.load_state_dict(start)
    pstep = make_train_step(StepConfig(add_loss="ang_iso",
                                       remat_policy=remat_policy),
                            device="cpu")
    p_losses = []
    for s in range(WARM, WARM + K):
        m = pstep(pstate, {"feat": torch.from_numpy(feats[s]),
                           "label": torch.from_numpy(labels)})
        p_losses.append(float(m["ang_iso"]))
    return dict(start=start, end=end, got=pstate.state_dict(),
                j_losses=np.array(j_losses), p_losses=np.array(p_losses))


def test_trajectory_losses_stats_and_params_track_jax(trajectory):
    """Losses rtol 2e-3 (tests/test_training_parity.py:123); BN running
    statistics and the center atol 5e-3; params within 2 lr K, since Adam
    turns noise-level gradient differences into steps of up to lr."""
    check_ecapa_trajectory(trajectory)


def check_ecapa_trajectory(t) -> None:
    """The bars of ``test_trajectory_losses_stats_and_params_track_jax``."""
    np.testing.assert_allclose(t["p_losses"], t["j_losses"], rtol=2e-3)
    assert t["got"]["step"] == t["end"]["step"] == WARM + K
    want, got = t["end"]["model"], t["got"]["model"]
    for k, w in want.items():
        atol = 5e-3 if k.endswith(("running_mean", "running_var")) \
            else 2 * LR * K
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(t["got"]["loss_module"]["center"].numpy(),
                               t["end"]["loss_module"]["center"].numpy(),
                               atol=5e-3)
    assert set(t["got"]["optimizer"]) == set(t["end"]["optimizer"])


def test_trajectory_moves_fc7_and_bn7_by_weight_decay_alone(trajectory):
    """fc7 and bn7 get no gradient from OC-Softmax (the logits feed only
    the logged CE), yet coupled L2 moves them in JAX: the port must give
    them zero gradients, or torch.optim.Adam would skip them. Their update
    is the same arithmetic in both packages (atol 1e-6). The two biases
    start at zero, where the decay is zero too, so only the two weights
    move."""
    t = trajectory
    names = [k for k in t["end"]["optimizer"] if k.startswith(("fc7", "bn7"))]
    assert len(names) == 4
    moved = []
    for k in names:
        start = t["start"]["model"][k].numpy()
        got = t["got"]["model"][k].numpy()
        np.testing.assert_allclose(got, t["end"]["model"][k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
        if np.abs(got - start).max() > LR / 4:
            moved.append(k)
        np.testing.assert_allclose(
            t["got"]["optimizer"][k]["exp_avg"].numpy(),
            t["end"]["optimizer"][k]["exp_avg"].numpy(), rtol=1e-4,
            atol=1e-9, err_msg=k)
    assert sorted(moved) == ["bn7.weight", "fc7.weight"]


def _write_part(root, part, n, seed, length):
    g = np.random.default_rng(seed)
    wav_dir = os.path.join(root, "LA", f"ASVspoof2019_LA_{part}", "wav")
    proto_dir = os.path.join(root, "LA", "ASVspoof2019_LA_cm_protocols")
    os.makedirs(wav_dir)
    os.makedirs(proto_dir, exist_ok=True)
    lines = []
    for i in range(n):
        label = i % 2
        wav = 0.1 * g.standard_normal(length + 37 * i)
        if label:
            t = np.arange(len(wav)) / 16000.0
            wav = 0.3 * np.sin(2 * np.pi * (300 + 7 * i) * t) + 0.02 * wav
        fname = f"LA_{part[0].upper()}_{i:07d}"
        write_wav(os.path.join(wav_dir, fname + ".wav"), wav)
        lines.append(f"LA_0001 {fname} - {'A07' if label else '-'} "
                     f"{'spoof' if label else 'bonafide'}")
    with open(os.path.join(proto_dir, f"ASVspoof2019.LA.cm.{part}.trl.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")


def _jax_summary_keys():
    """The keys the JAX ``train`` puts in its summary, read from its
    source: the dict it starts from, ``summary.update(...)`` and
    ``summary[...] =``."""
    keys = set()
    for node in ast.walk(ast.parse(inspect.getsource(jloop.train))):
        if isinstance(node, ast.AnnAssign) and isinstance(node.value,
                                                          ast.Dict):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and getattr(node.func.value, "id", "") == "summary"):
            keys |= {kw.arg for kw in node.keywords}
        elif (isinstance(node, ast.Subscript)
              and getattr(node.value, "id", "") == "summary"
              and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def test_train_end_to_end_on_cpu(tmp_path):
    """Two epochs of the port's train() from a wav corpus: the logs, epoch
    checkpoints and best are written, a checkpoint restores to the live
    state, and the summary has the JAX train's keys."""
    db = str(tmp_path / "db")
    _write_part(db, "train", 16, 0, 7000)
    _write_part(db, "dev", 8, 1, 7000)
    cfg = TrainConfig(out_fold=str(tmp_path / "out"), path_to_database=db,
                      model="ecapa", add_loss="ang_iso", on_the_fly=True,
                      batch_size=8, feat_len=T, num_epochs=2, C=C,
                      model_scale=SCALE, enc_dim=ENC, ratio=1.0)
    summary, state = train(cfg, device="cpu", return_state=True)
    assert set(summary) == _jax_summary_keys() == {
        "epochs", "dev_loss", "dev_eer", "epoch_seconds", "best_dev_loss"}
    assert summary["epochs"] == 2 and state.step == 4
    assert np.isfinite(summary["dev_loss"]) and 0 <= summary["dev_eer"] <= 1
    out = cfg.out_fold
    with open(os.path.join(out, "train_loss.log")) as f:
        rows = [line.split() for line in f.readlines()[1:]]
    assert [r[:2] for r in rows] == [["0", "0"], ["0", "1"], ["1", "0"],
                                     ["1", "1"]]
    assert all(np.isfinite(float(r[2])) for r in rows)
    with open(os.path.join(out, "dev_loss.log")) as f:
        assert len(f.readlines()) == 3
    for name in ("args.json", "train_meta.json", "best.pt",
                 os.path.join("checkpoint", "1.pt"),
                 os.path.join("checkpoint", "2.pt")):
        assert os.path.exists(os.path.join(out, name)), name

    fresh = setup_training(cfg, 2, device="cpu")[2]
    restore_checkpoint(os.path.join(out, "checkpoint", "2.pt"), fresh)
    live, back = state.state_dict(), fresh.state_dict()
    assert back["step"] == live["step"] == 4
    for part in ("model", "loss_module"):
        for k, v in live[part].items():
            assert torch.equal(back[part][k], v), k
    assert set(back["optimizer"]) == set(live["optimizer"])
    for name, st in live["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(back["optimizer"][name][k], v), (name, k)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    """``python -m asvspoof2021_air_tpu_torch.cli.train`` with the JAX
    CLI's flags and ``--device cpu``: one epoch, the summary printed."""
    db = str(tmp_path / "db")
    _write_part(db, "train", 8, 2, 7000)
    _write_part(db, "dev", 8, 3, 7000)
    out = str(tmp_path / "out")
    cli_main(["-d", db, "-o", out, "-m", "ecapa", "--add_loss", "ang_iso",
              "--on_the_fly", "--device", "cpu", "--C", str(C),
              "--model_scale", str(SCALE), "--enc_dim", str(ENC),
              "--feat_len", str(T), "--batch_size", "8", "--num_epochs", "1",
              "--ratio", "1.0"])
    assert "'dev_eer'" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "best.pt"))
    with open(os.path.join(out, "args.json")) as f:
        args = json.load(f)
    assert (args["add_loss"], args["C"], args["on_the_fly"]) == (
        "ang_iso", C, True)


def test_cli_loads_a_jax_config_file_and_refuses_fused_off(tmp_path):
    """A JAX ``args.json`` loads: the fields the port does not read are
    dropped and the rest kept, ADV_AUG's lambda_ and RawNet2's
    rawnet_args among them, fused_pool and fused_bn ("auto") too. One that
    turns fused_pool or fused_bn off is no longer refused: the value
    reaches the config, and ``setup_training`` builds the unfused model
    (its ReLU -> BN pairs unfused; ECAPA's pooling unfused), where "auto"
    builds the fused one."""
    rawnet_args = {"nb_samp": 6400, "first_conv": 129, "gru_node": 16}
    jcfg = dataclasses.asdict(jloop.TrainConfig(
        model="ecapa", add_loss="ang_iso", on_the_fly=True, lr=3e-4,
        lambda_=0.1, path_to_features="/feats", rawnet_args=rawnet_args))
    path = tmp_path / "args.json"
    out = ["-o", str(tmp_path / "out"), "--config", str(path)]
    path.write_text(json.dumps(jcfg))
    cfg = config_from_args(cli_parse_args(out))
    assert (cfg.model, cfg.add_loss, cfg.on_the_fly, cfg.lr) == (
        "ecapa", "ang_iso", True, 3e-4)
    assert cfg.lambda_ == 0.1 and not hasattr(cfg, "num_centers")
    assert (cfg.fused_pool, cfg.fused_bn) == ("auto", "auto")
    assert cfg.rawnet_args == rawnet_args
    small = dict(C=C, model_scale=SCALE, enc_dim=ENC, feat_len=T)
    for key in ("fused_pool", "fused_bn"):
        path.write_text(json.dumps({**jcfg, key: "off"}))
        cfg = config_from_args(cli_parse_args(out))
        assert getattr(cfg, key) == "off"
        model = setup_training(dataclasses.replace(cfg, **small), 2,
                               device="cpu")[0]
        pairs = [model.bn1, model.attention[2], model.layer1.bn1,
                 *model.layer1.bns, model.layer3.bn3]
        assert all(m.fused == (key != "fused_bn") for m in pairs), key
        assert model.fused_pool == (key != "fused_pool"), key


def test_unsupported_flags_raise(tmp_path):
    """No flag is refused by name any more: ``visualize`` passes
    ``check_supported`` (tests/test_torch_visualize.py trains with it), as
    ``ensemble`` does (tests/test_torch_ensemble.py trains it); the ones it trains with (bf16, K steps
    per call, feature files with or without an aug flag, resume,
    test_on_eval, profile, ADV_AUG and the channel augmenter, all six
    model families and every add-loss that trains) are held by
    tests/test_torch_train_loop.py, tests/test_torch_train_bf16.py,
    tests/test_torch_adv_aug.py, tests/test_torch_train_families.py and
    the families' files (tests/test_torch_res2net.py,
    tests/test_torch_convnet.py, tests/test_torch_rawnet_train.py). Every
    family passes ``check_supported``; RawNet2 with an add-loss raises
    ValueError, as the JAX ``setup_training`` does, and so does RawNet2
    from feature files (it reads waveforms). AMSoftmax does not train: the
    step raises ValueError, as the JAX step does."""
    base = dict(out_fold=str(tmp_path / "o"), model="ecapa", on_the_fly=True)
    check_supported(TrainConfig(**{**base, "visualize": True}))
    check_supported(TrainConfig(**{**base, "ensemble": 2}))
    for model in ("cnn", "resnet", "lcnn", "res2net", "ecapa", "rawnet"):
        check_supported(TrainConfig(**{**base, "model": model}))
    with pytest.raises(ValueError, match="rawnet"):
        train(TrainConfig(**{**base, "model": "rawnet",
                             "add_loss": "ang_iso"}), device="cpu")
    with pytest.raises(ValueError, match="on_the_fly"):
        train(TrainConfig(**{**base, "model": "rawnet",
                             "on_the_fly": False}), device="cpu")
    with pytest.raises(ValueError, match="add_loss"):
        make_train_step(StepConfig(add_loss="amsoftmax"), device="cpu")
