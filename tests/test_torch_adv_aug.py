"""Channel-robust training in the port against the JAX package, on the CPU
at small shapes: the gradient-reversal layer and the channel classifier,
ADV_AUG training steps (one classifier, and two for LAPA/DFPA) against the
JAX step, ``train()`` with ADV_AUG from augmented feature files and with
the on-device channel augmenter on the fly, K steps per call, resume, the
CLI's flags, and a JAX ADV_AUG run carried across by the converter.

Tolerances, stated per test: the GRL and the classifier 1e-6; a
trajectory by PERF.md section 2's f32 bars (losses rtol 2e-3, BN
statistics and the center atol 5e-3, parameters within 2 lr K, the
classifiers' within 2 lr_d K: Adam turns noise-level gradient differences
into steps of up to its rate), accuracies within one sample of the batch.
Those bars hold the values; the updates are held tighter, since a bar of
2 lr K would pass a parameter left where it started: the classifiers'
update (end - start) per element within 2% of the rates summed over the
steps, and their Adam moments within 1e-4 of each tensor's largest
moment (the moments are linear in the gradients, so a gradient scaled or
of another loss shows there although Adam's normalised step hides it);
the backbone's update within 1e-2 of its norm.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.losses import build_loss
from asvspoof2021_air_tpu.models import registry as j_registry
from asvspoof2021_air_tpu.models.classifier import (
    ChannelClassifier as JClassifier)
from asvspoof2021_air_tpu.models.classifier import (
    gradient_reversal as j_gradient_reversal)
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.train import state as jstate
from asvspoof2021_air_tpu.train.checkpoint import save_checkpoint
from asvspoof2021_air_tpu.train.loop import TrainConfig as JConfig
from asvspoof2021_air_tpu.train.loop import setup_training as j_setup
from asvspoof2021_air_tpu.train.steps import StepConfig as JStepConfig
from asvspoof2021_air_tpu.train.steps import make_train_step as j_make_step
from asvspoof2021_air_tpu_torch.cli.train import config_from_args
from asvspoof2021_air_tpu_torch.cli.train import parse_args as cli_parse_args
from asvspoof2021_air_tpu_torch.data import protocol as proto
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_classifier, from_flax_train_state)
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.models.classifier import (
    ChannelClassifier, gradient_reversal)
from asvspoof2021_air_tpu_torch.train.checkpoint import restore_checkpoint
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
from asvspoof2021_air_tpu_torch.train.loop import (
    TrainConfig, setup_training, train)
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import (
    StepConfig, make_multi_step, make_train_step)

from test_torch_train import (B, C, ENC, LR, SCALE, T, _jmodel, _port_model,
                              _write_part)

LR_D = 1e-4
LAMBDA = 0.05
ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_torch", ROOT / "tools" / "jax_checkpoint_to_torch.py")
converter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(converter)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small training runs: beside the
    suite's other workers, torch's default of a thread per core
    oversubscribes the CPU (a 1 s training run took 100 s there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the GRL and the classifier ----

def test_gradient_reversal_matches_jax():
    """Identity forward; backward -lambda g, as the JAX custom_vjp."""
    g = np.random.default_rng(0)
    x = g.standard_normal((5, 7)).astype(np.float32)
    ct = g.standard_normal((5, 7)).astype(np.float32)
    for lam in (1.0, 0.05):
        y, vjp = jax.vjp(lambda v: j_gradient_reversal(v, lam),
                         jnp.asarray(x))
        xt = _t(x).requires_grad_()
        yt = gradient_reversal(xt, lam)
        yt.backward(_t(ct))
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
        np.testing.assert_allclose(xt.grad.numpy(),
                                   np.asarray(vjp(jnp.asarray(ct))[0]),
                                   rtol=0, atol=1e-6)


def test_channel_classifier_matches_flax_and_never_drops_in_train_mode():
    """The flax classifier's params through ``from_flax_classifier``: the
    outputs and the input gradient through the GRL within 1e-6; the state
    dict's names are the reference's. The module's train mode does not
    turn dropout on (JAX calls it with train=False); train=True does."""
    jc = JClassifier(ENC, 60, LAMBDA)
    x = np.random.default_rng(1).standard_normal((B, ENC)).astype(np.float32)
    params = jc.init(jax.random.PRNGKey(2), jnp.asarray(x), False)["params"]
    want, vjp = jax.vjp(lambda v: jc.apply({"params": params}, v, False),
                        jnp.asarray(x))
    ct = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    clf = ChannelClassifier(ENC, 60, LAMBDA, device="cpu")
    sd = from_flax_classifier(params)
    assert set(sd) == set(clf.state_dict()) == {
        "classifier.0.weight", "classifier.0.bias", "classifier.3.weight",
        "classifier.3.bias"}
    clf.load_state_dict(sd)
    clf.train()
    xt = _t(x).requires_grad_()
    got = clf(xt)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]), rtol=0,
                               atol=1e-6)
    assert torch.equal(clf(_t(x)), got.detach())
    torch.manual_seed(0)
    assert not torch.equal(clf(_t(x), train=True), got.detach())


def test_channel_classifier_init_is_flax_kaiming_uniform():
    """Kernels uniform in +-sqrt(6 / fan_in) with flax's spread (std
    within 3% of the JAX init's), biases zero."""
    clf = ChannelClassifier(256, 60, generator=torch.Generator().manual_seed(
        0), device="cpu")
    jp = JClassifier(256, 60).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 256)), False)["params"]
    for i, name in ((0, "Dense_0"), (3, "Dense_1")):
        lin = clf.classifier[i]
        limit = np.sqrt(6.0 / lin.in_features)
        w, jw = lin.weight.detach().numpy(), np.asarray(jp[name]["kernel"])
        assert np.abs(w).max() <= limit and np.abs(jw).max() <= limit
        assert abs(w.std() / jw.std() - 1) < 0.03
        assert not lin.bias.detach().any()


# ---- ADV_AUG steps against JAX ----

WARM, N = 2, 6
GATES = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]


def _channels(g, n: int, dual: bool) -> np.ndarray:
    ch = g.integers(0, len(proto.LA_CHANNELS), (n, B))
    if dual:
        ch = np.stack([ch, g.integers(0, len(proto.DEVICES), (n, B))], -1)
    return ch.astype(np.int32)


def _rate_sum(base: float, first: int, n: int) -> float:
    """The rates of steps first .. first + n - 1 of the tests' schedule
    (halved every 2 steps), summed: the most an Adam step can move an
    element over them, to first order."""
    sched = step_decay_schedule(base, 0.5, 1, 2)
    return sum(sched(s) for s in range(first, first + n))


def _assert_updates_match(got, want, start, name: str, opt: str,
                          rate_sum: float) -> None:
    """``name``'s parameters moved from ``start`` as JAX's did: each
    element's update within 0.02 ``rate_sum`` of JAX's update, and Adam's
    first and second moments within 1e-4 of the tensor's largest moment
    in JAX. A step of the wrong sign, no step, or a step on a gradient
    scaled or taken of another loss each fails one of the two."""
    assert set(got[opt]) == set(want[opt]) == set(want[name]), name
    for k, w in want[name].items():
        update = got[name][k] - start[name][k]
        np.testing.assert_allclose(
            update.numpy(), (w - start[name][k]).numpy(), rtol=0,
            atol=0.02 * rate_sum, err_msg=f"{name} {k} update")
        for moment in ("exp_avg", "exp_avg_sq"):
            wm = want[opt][k][moment]
            np.testing.assert_allclose(
                got[opt][k][moment].numpy(), wm.numpy(), rtol=0,
                atol=1e-4 * float(wm.abs().max()),
                err_msg=f"{opt} {k} {moment}")


def _trained(sd):
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def _port_adv_state(dual: bool):
    clf2 = (ChannelClassifier(ENC, len(proto.DEVICES), LAMBDA, device="cpu")
            if dual else None)
    return create_train_state(
        _port_model(), OCSoftmax(feat_dim=ENC, r_real=0.9, r_fake=0.2,
                                 alpha=20.0, device="cpu"),
        step_decay_schedule(LR, 0.5, 1, 2),
        classifier=ChannelClassifier(ENC, len(proto.LA_CHANNELS), LAMBDA,
                                     device="cpu"),
        classifier2=clf2, schedule_d=step_decay_schedule(LR_D, 0.5, 1, 2))


@pytest.fixture(scope="module", params=[False, True], ids=["single", "dual"])
def adv_trajectory(request):
    """WARM JAX steps from init at gate 0, the state carried across by
    from_flax_train_state, then N steps in each package on the same batches
    with the gate 0, 0, 0, 1, 1, 1. Both rates halve every 2 steps."""
    dual = request.param
    g = np.random.default_rng(10 + dual)
    labels = (np.arange(B) % 2).astype(np.int32)
    feats = g.standard_normal((WARM + N, B, T, 60)).astype(np.float32)
    feats += 0.5 * labels[None, :, None, None]
    channel = _channels(g, WARM + N, dual)
    model = _jmodel()
    loss_mod = build_loss("ang_iso", enc_dim=ENC, r_real=0.9, r_fake=0.2,
                          alpha=20.0)
    btx = jstate.make_backbone_optimizer(jstate.step_decay_schedule(
        LR, 0.5, 1, 2))
    ltx = jstate.make_loss_optimizer(jstate.step_decay_schedule(
        LR, 0.5, 1, 2))
    ctx = jstate.make_backbone_optimizer(jstate.step_decay_schedule(
        LR_D, 0.5, 1, 2))
    clf = JClassifier(ENC, len(proto.LA_CHANNELS), LAMBDA)
    clf2 = JClassifier(ENC, len(proto.DEVICES), LAMBDA) if dual else None
    state = jstate.create_train_state(
        jax.random.PRNGKey(0), model, jnp.asarray(feats[0]),
        loss_module=loss_mod, example_feat=jnp.zeros((B, ENC)),
        example_labels=jnp.asarray(labels), backbone_tx=btx, loss_tx=ltx,
        classifier=clf, classifier_tx=ctx, classifier2=clf2)
    step = jax.jit(j_make_step(
        model, loss_mod, btx, ltx,
        JStepConfig(add_loss="ang_iso", adv_aug=True, dual_classifier=dual),
        classifier=clf, classifier_tx=ctx, classifier2=clf2))
    batch = lambda s: {"feat": feats[s], "label": labels,
                       "channel": channel[s]}
    key = jax.random.PRNGKey(1)
    for s in range(WARM):
        state, _ = step(state, jax.tree.map(jnp.asarray, batch(s)), key,
                        jnp.float32(0.0))
    start = from_flax_train_state(jax.device_get(state), SCALE)
    j_metrics = []
    for s, gate in zip(range(WARM, WARM + N), GATES):
        state, m = step(state, jax.tree.map(jnp.asarray, batch(s)), key,
                        jnp.float32(gate))
        j_metrics.append({k: float(v) for k, v in m.items()})
    end = from_flax_train_state(jax.device_get(state), SCALE)

    pstate = _port_adv_state(dual)
    pstate.load_state_dict(start)
    pstep = make_train_step(StepConfig(add_loss="ang_iso", adv_aug=True,
                                       dual_classifier=dual), device="cpu")
    p_metrics = []
    for s, gate in zip(range(WARM, WARM + N), GATES):
        m = pstep(pstate, {k: _t(v) for k, v in batch(s).items()}, None,
                  gate)
        p_metrics.append({k: float(v) for k, v in m.items()})
    return dict(dual=dual, start=start, end=end, got=pstate.state_dict(),
                j=j_metrics, p=p_metrics)


def test_adv_trajectory_tracks_jax(adv_trajectory):
    t = adv_trajectory
    assert [sorted(m) for m in t["p"]] == [sorted(m) for m in t["j"]]
    assert {"adv_loss", "adv_acc", "clf_loss", "clf_acc"} <= set(t["p"][0])
    for pm, jm in zip(t["p"], t["j"]):
        for k in pm:
            if k.endswith("_acc"):
                assert abs(pm[k] - jm[k]) <= 1.0 / B, (k, pm[k], jm[k])
            else:
                np.testing.assert_allclose(pm[k], jm[k], rtol=2e-3,
                                           err_msg=k)
    # the gate enters the total loss: ang_iso + gate * adv_loss
    for pm, gate in zip(t["p"], GATES):
        np.testing.assert_allclose(pm["total_loss"],
                                   pm["ang_iso"] + gate * pm["adv_loss"],
                                   rtol=1e-6)
    got, want = t["got"], t["end"]
    assert got["step"] == want["step"] == WARM + N
    for k, w in want["model"].items():
        atol = 5e-3 if k.endswith(("running_mean", "running_var")) \
            else 2 * LR * N
        np.testing.assert_allclose(got["model"][k].numpy(), w.numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    np.testing.assert_allclose(got["loss_module"]["center"].numpy(),
                               want["loss_module"]["center"].numpy(),
                               atol=5e-3)
    names = ["classifier"] + (["classifier2"] if t["dual"] else [])
    assert (got["classifier2"] is None) == (want["classifier2"] is None) \
        == (not t["dual"])
    # the backbone's update, end - start, against JAX's by its norm
    start = _trained(t["start"]["model"])
    diff = sum(float(((got["model"][k] - want["model"][k]) ** 2).sum())
               for k in start)
    norm = sum(float(((want["model"][k] - v) ** 2).sum())
               for k, v in start.items())
    assert diff ** 0.5 <= 1e-2 * norm ** 0.5, (diff ** 0.5, norm ** 0.5)
    for name, opt in zip(names, ("clf_optimizer", "clf2_optimizer")):
        for k, w in want[name].items():
            assert not torch.equal(w, t["start"][name][k])     # they train
            np.testing.assert_allclose(got[name][k].numpy(), w.numpy(),
                                       rtol=0, atol=2 * LR_D * N,
                                       err_msg=f"{name} {k}")
        _assert_updates_match(got, want, t["start"], name, opt,
                              _rate_sum(LR_D, WARM, N))
        for k, st in got[opt].items():
            assert float(st["step"]) == float(want[opt][k]["step"])


def test_classifier_update_does_not_depend_on_the_gate():
    """The classifier phase is never gated and trains on the detached
    embeddings with the parameters from before the step, so one step at
    gate 0 and one at gate 1 from one state leave the classifiers equal bit
    for bit and the backbone different: the adversarial term's gradient
    reaches the backbone only."""
    g = np.random.default_rng(4)
    batch = {"feat": _t(g.standard_normal((B, T, 60)).astype(np.float32)),
             "label": _t((np.arange(B) % 2).astype(np.int32)),
             "channel": _t(_channels(g, 1, True)[0])}
    step = make_train_step(StepConfig(add_loss="ang_iso", adv_aug=True,
                                      dual_classifier=True), device="cpu")
    init = _port_adv_state(True).state_dict()
    after = []
    for gate in (0.0, 1.0):
        st = _port_adv_state(True)
        st.load_state_dict(init)
        m = step(st, batch, None, gate)
        after.append((m, st.state_dict()))
    (m0, s0), (m1, s1) = after
    for name in ("classifier", "classifier2"):
        for k, v in s0[name].items():
            assert torch.equal(v, s1[name][k]), (name, k)
            assert not torch.equal(v, init[name][k]), (name, k)
    assert torch.equal(m0["clf_loss"], m1["clf_loss"])
    assert torch.equal(m0["adv_loss"], m0["clf_loss"])
    assert not torch.equal(s0["model"]["fc6.weight"], s1["model"]["fc6.weight"])


# ---- train() ----

def _write_aug_features(root, part, n, seed, variant, with_device):
    """Augmented LFCC-shaped .npy files named as the reference's cache
    names them, each with a channel (and a device) suffix from the
    variant's vocabulary."""
    channels = (proto.LA_CHANNELS if variant == "LA" else
                proto.DF_CHANNELS)[1:]
    d = os.path.join(root, part, "LFCC")
    os.makedirs(d)
    g = np.random.default_rng(seed)
    for i in range(n):
        label = i % 2
        x = g.standard_normal((1, T + 3 * (i % 5) - 6, 60)) + 0.7 * label
        suffix = f"_{channels[i % len(channels)]}"
        if with_device:
            suffix += f"_{proto.DEVICES[i % (len(proto.DEVICES) - 1)]}"
        name = (f"{i:06d}_LA_T_{1000000 + i}_{'A01' if label else '-'}_"
                f"{'spoof' if label else 'bonafide'}{suffix}")
        np.save(os.path.join(d, name + ".npy"), x.astype(np.float32))


def _write_ori_features(root, part, n, seed):
    d = os.path.join(root, part, "LFCC")
    os.makedirs(d)
    g = np.random.default_rng(seed)
    for i in range(n):
        label = i % 2
        x = g.standard_normal((1, T, 60)) + 0.7 * label
        name = (f"{i:06d}_LA_T_{2000000 + i}_{'A01' if label else '-'}_"
                f"{'spoof' if label else 'bonafide'}")
        np.save(os.path.join(d, name + ".npy"), x.astype(np.float32))


@pytest.fixture(scope="module")
def adv_trees(tmp_path_factory):
    """ori/{train,dev}, and aug trees per variant: LA, DF, and each with
    devices."""
    root = tmp_path_factory.mktemp("adv")
    ori = str(root / "ori")
    _write_ori_features(ori, "train", 8, 0)
    _write_ori_features(ori, "dev", 8, 1)
    augs = {}
    for variant in ("LA", "DF"):
        for dev in (False, True):
            path = str(root / f"aug_{variant}_{dev}")
            _write_aug_features(path, "train", 8, 2, variant, dev)
            _write_aug_features(path, "dev", 8, 3, variant, dev)
            augs[variant, dev] = path
    return ori, augs


def _adv_config(tmp_path, ori, aug, flag, **kw):
    return TrainConfig(**{**dict(
        out_fold=str(tmp_path / "out"), path_to_features=ori,
        path_to_aug_features=aug, model="ecapa", add_loss="ang_iso",
        batch_size=B, feat_len=T, num_epochs=2, C=C, model_scale=SCALE,
        enc_dim=ENC, ADV_AUG=True, ratio=0.5, lr_d=2e-4, lambda_=0.1,
        **{flag: True}), **kw})


@pytest.mark.parametrize("flag,dtype,k", [
    ("LA_aug", "float32", 1), ("DF_aug", "bfloat16", 2),
    ("LAPA_aug", "float32", 2), ("DFPA_aug", "bfloat16", 1)])
def test_train_adv_aug_from_feature_files(tmp_path, adv_trees, flag, dtype,
                                          k):
    """Two epochs of ADV_AUG from augmented feature files (the gate off in
    the first, on in the second), f32 and bf16, one and two steps per
    call: the classifiers over the variant's channels (and the devices),
    built with lambda_ and trained at lr_d, move; the logs and the summary
    are written."""
    ori, augs = adv_trees
    variant = "LA" if flag in ("LA_aug", "LAPA_aug") else "DF"
    dual = flag in ("LAPA_aug", "DFPA_aug")
    cfg = _adv_config(tmp_path, ori, augs[variant, dual], flag,
                      compute_dtype=dtype, steps_per_call=k)
    init = setup_training(cfg, 2, device="cpu")[2].state_dict()
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    n_ch = len(proto.LA_CHANNELS if variant == "LA" else proto.DF_CHANNELS)
    assert state.classifier.classifier[3].out_features == n_ch
    assert state.classifier.lambda_ == 0.1
    assert (state.classifier2 is not None) == dual
    if dual:
        assert state.classifier2.classifier[3].out_features == len(
            proto.DEVICES)
    assert state.clf_optimizer.param_groups[0]["lr"] == 2e-4
    live = state.state_dict()
    for name in ("classifier",) + (("classifier2",) if dual else ()):
        assert all(not torch.equal(v, init[name][key])
                   for key, v in live[name].items()), name
    with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
        rows = [line.split() for line in f.readlines()[1:]]
    assert len(rows) == state.step and all(np.isfinite(float(r[2]))
                                           for r in rows)


def test_adv_aug_refusals(tmp_path, adv_trees):
    """ADV_AUG needs an aug flag (the JAX message) and feature files: on
    the fly the batches carry no channel ids."""
    ori, augs = adv_trees
    with pytest.raises(ValueError, match="ADV_AUG requires an augmentation "
                                         "flag"):
        train(TrainConfig(out_fold=str(tmp_path / "o"), model="ecapa",
                          path_to_features=ori, ADV_AUG=True), device="cpu")
    with pytest.raises(ValueError, match="ADV_AUG with on_the_fly"):
        train(TrainConfig(out_fold=str(tmp_path / "o"), model="ecapa",
                          on_the_fly=True, LA_aug=True, ADV_AUG=True),
              device="cpu")


def test_auto_resume_and_continue_training_restore_the_classifiers(
        tmp_path, adv_trees):
    """The classifiers and their Adam states are in the epoch checkpoints
    and best.pt: a resumed run continues from them (a third epoch after
    two), continue_training loads them from best.pt."""
    ori, augs = adv_trees
    cfg = _adv_config(tmp_path, ori, augs["LA", True], "LAPA_aug",
                      auto_resume=True)
    _, state = train(cfg, device="cpu", return_state=True)
    live = state.state_dict()
    ckpt = restore_checkpoint(os.path.join(cfg.out_fold, "checkpoint",
                                           "2.pt"))
    for name in ("classifier", "classifier2"):
        for k, v in live[name].items():
            assert torch.equal(ckpt[name][k], v), (name, k)
    for opt in ("clf_optimizer", "clf2_optimizer"):
        for p, st in live[opt].items():
            for k, v in st.items():
                assert torch.equal(ckpt[opt][p][k], v), (opt, p, k)
    # resume with no epoch left to run: the state is the checkpoint's
    _, again = train(cfg, device="cpu", return_state=True)
    assert again.step == state.step
    for k, v in again.state_dict()["classifier2"].items():
        assert torch.equal(v, live["classifier2"][k]), k
    # a third epoch from 2.pt, as one from the live state would go
    s3, third = train(dataclasses.replace(cfg, num_epochs=3), device="cpu",
                      return_state=True)
    assert s3["epochs"] == 3 and third.step == state.step * 3 // 2
    best = restore_checkpoint(os.path.join(cfg.out_fold, "best.pt"))
    _, cont = train(dataclasses.replace(cfg, continue_training=True,
                                        auto_resume=False, num_epochs=0),
                    device="cpu", return_state=True)
    for name in ("classifier", "classifier2"):
        for k, v in getattr(cont, name).state_dict().items():
            assert torch.equal(v, best[name][k]), (name, k)


def _otf_config(tmp_path, db, **kw):
    return TrainConfig(**{**dict(
        out_fold=str(tmp_path / "out"), path_to_database=db, model="ecapa",
        add_loss="ang_iso", on_the_fly=True, batch_size=B, feat_len=T,
        num_epochs=1, C=C, model_scale=SCALE, enc_dim=ENC, ratio=1.0,
        on_device_aug=True, apply_ir=True), **kw})


@pytest.fixture(scope="module")
def wav_db(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("db"))
    _write_part(db, "train", 16, 5, 7000)
    _write_part(db, "dev", 8, 6, 7000)
    return db


def test_train_on_the_fly_with_the_augmenter(tmp_path, wav_db):
    """on_device_aug + apply_ir + dev_aug: the training steps see the
    augmented waveforms (the run differs from a clean one), the dev pass
    an augmented view with the same draws every epoch (its loss differs
    from the clean dev pass's); two identical runs agree bit for bit."""
    runs = {}
    for name, kw in (("aug", {"dev_aug": True}), ("again", {"dev_aug": True}),
                     ("clean_dev", {}),
                     ("clean", {"on_device_aug": False, "apply_ir": False})):
        cfg = _otf_config(tmp_path / name, wav_db, **kw)
        summary, state = train(cfg, device="cpu", return_state=True)
        assert summary["epochs"] == 1 and np.isfinite(summary["dev_loss"])
        runs[name] = (summary, state.state_dict())
    (sa, a), (_, b) = runs["aug"], runs["again"]
    assert all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    assert sa["dev_loss"] == runs["again"][0]["dev_loss"]
    # the same trained weights: the dev_aug run and the clean-dev run train
    # alike, and only their dev passes differ
    c = runs["clean_dev"][1]
    assert all(torch.equal(v, c["model"][k]) for k, v in a["model"].items())
    assert sa["dev_loss"] != runs["clean_dev"][0]["dev_loss"]
    clean = runs["clean"][1]
    assert not torch.equal(a["model"]["conv1.weight"],
                           clean["model"]["conv1.weight"])


def test_multi_step_with_the_augmenter_equals_single_steps_bitwise(
        tmp_path, wav_db):
    """K = 2 on the CPU: the same metrics and state as two single steps,
    bit for bit, with the augmenter's draws a function of (seed, step)
    alone; a step at another count draws otherwise."""
    from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
    from asvspoof2021_air_tpu_torch.data.pipeline import WaveformIterator
    from asvspoof2021_air_tpu_torch.ops.augment import (
        ChannelAugmenter, synthetic_ir_bank)

    cfg = _otf_config(tmp_path, wav_db)
    fe = OnDeviceFrontend(feat_len=T, augmenter=ChannelAugmenter(
        ir_bank=synthetic_ir_bank(), device="cpu"), apply_ir=True,
        device="cpu")
    it = WaveformIterator(RawAudioDataset("LA", wav_db, "train"), B,
                          fe.min_samples(), seed=1, steps_per_epoch=2)
    batches = [{k: _t(b[k]) for k in ("wave", "length", "label")}
               for b in it.epoch()]
    rng = 688 ^ 0x5EED
    runs = []
    for multi in (False, True):
        _, _, state, step, _ = setup_training(cfg, 4, frontend=fe,
                                              device="cpu")
        if multi:
            m = make_multi_step(step, 2)(state, {
                k: torch.stack([b[k] for b in batches])
                for k in batches[0]}, rng, 0.0, fe.params)
        else:
            ms = [step(state, b, rng, 0.0, fe.params) for b in batches]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((m, state.state_dict()))
    (m1, s1), (m2, s2) = runs
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k, v in s1["model"].items():
        assert torch.equal(v, s2["model"][k]), k
    d0, d0b, d1 = (step.draw(rng, s, batches[0]) for s in (0, 0, 1))
    assert all(torch.equal(d0[k], d0b[k]) for k in d0)
    assert not torch.equal(d0["noise"], d1["noise"])
    with pytest.raises(ValueError, match="rng"):
        step(state, batches[0])


# ---- the CLI and the converter ----

def test_cli_takes_the_adv_and_augmenter_flags(tmp_path):
    """The JAX CLI's parsing: ``--ADV_AUG`` and the augmenter's flags take
    an optional boolean, ``--lambda_`` and ``--lr_d`` floats; a JAX
    ``--config`` file carries them too."""
    out = ["-o", str(tmp_path / "o")]
    cfg = config_from_args(cli_parse_args(out + [
        "--ADV_AUG", "--LAPA_aug", "true", "--lambda_", "0.2", "--lr_d",
        "3e-4", "--on_device_aug", "--apply_ir", "yes", "--dev_aug"]))
    assert (cfg.ADV_AUG, cfg.LAPA_aug, cfg.lambda_, cfg.lr_d,
            cfg.on_device_aug, cfg.apply_ir, cfg.dev_aug) == (
        True, True, 0.2, 3e-4, True, True, True)
    cfg = config_from_args(cli_parse_args(out + ["--ADV_AUG", "false"]))
    assert (cfg.ADV_AUG, cfg.lambda_, cfg.lr_d, cfg.on_device_aug) == (
        False, 0.05, 1e-4, False)
    path = tmp_path / "args.json"
    path.write_text(json.dumps(dataclasses.asdict(JConfig(
        model="ecapa", ADV_AUG=True, DF_aug=True, lambda_=0.3, lr_d=5e-5,
        on_device_aug=True, dev_aug=True, apply_ir=True))))
    cfg = config_from_args(cli_parse_args(out + ["--config", str(path)]))
    assert (cfg.ADV_AUG, cfg.DF_aug, cfg.lambda_, cfg.lr_d,
            cfg.on_device_aug, cfg.dev_aug, cfg.apply_ir) == (
        True, True, 0.3, 5e-5, True, True, True)


def test_jax_adv_run_through_the_converter_steps_as_jax(tmp_path,
                                                        monkeypatch):
    """A JAX LAPA_aug + ADV_AUG run's checkpoint, converted by
    ``tools/jax_checkpoint_to_torch.py``, keeps lambda_, lr_d, both
    classifiers and their Adam states; the port's state loaded from it
    takes one step (gate 1) as the JAX step does: losses rtol 2e-3, the
    classifiers within 2 lr_d, their update and Adam moments as in the
    trajectory test."""
    CK, ENCK = 64, 32
    monkeypatch.setitem(
        j_registry.MODEL_REGISTRY, "ecapa",
        lambda enc_dim=256, nclasses=2, feat_dim=60, **kw: JECAPA(
            C=CK, model_scale=8, n_out=2, n_feat=60, enc_dim=ENCK))
    jcfg = JConfig(out_fold=str(tmp_path / "jax"), model="ecapa",
                   add_loss="ang_iso", enc_dim=ENCK, feat_len=T,
                   ADV_AUG=True, LAPA_aug=True, lambda_=0.1, lr_d=2e-4)
    _, _, jst, jstep, _ = j_setup(jcfg, steps_per_epoch=4)
    g = np.random.default_rng(7)
    labels = (np.arange(B) % 2).astype(np.int32)
    batch = {"feat": g.standard_normal((B, T, 60)).astype(np.float32)
             + 0.5 * labels[:, None, None], "label": labels,
             "channel": _channels(g, 1, True)[0]}
    key = jax.random.PRNGKey(1)
    jst, _ = jstep(jst, jax.tree.map(jnp.asarray, batch), key,
                   jnp.float32(0.0))
    os.makedirs(tmp_path / "jax")
    with open(tmp_path / "jax" / "args.json", "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    save_checkpoint(str(tmp_path / "jax" / "best"), jst)
    converter.main(["--model_dir", str(tmp_path / "jax"), "--out",
                    str(tmp_path / "port")])
    args = json.load(open(tmp_path / "port" / "args.json"))
    assert (args["lambda_"], args["lr_d"], args["ADV_AUG"],
            args["LAPA_aug"]) == (0.1, 2e-4, True, True)
    ckpt = torch.load(tmp_path / "port" / "best.pt", weights_only=True)
    want = from_flax_train_state(jax.device_get(jst), 8)
    for name in ("classifier", "classifier2", "clf_optimizer",
                 "clf2_optimizer"):
        assert ckpt[name] is not None
    for name in ("classifier", "classifier2"):
        for k, v in want[name].items():
            assert torch.equal(ckpt[name][k], v), (name, k)
    assert float(ckpt["clf2_optimizer"]["classifier.3.bias"]["step"]) == 1

    pcfg = TrainConfig(**{k: v for k, v in args.items()
                          if k in TrainConfig.__dataclass_fields__})
    _, _, pst, pstep, _ = setup_training(pcfg, 4, device="cpu")
    pst.load_state_dict(ckpt)
    assert pst.classifier.lambda_ == 0.1
    jst, jm = jstep(jst, jax.tree.map(jnp.asarray, batch), key,
                    jnp.float32(1.0))
    pm = pstep(pst, {k: _t(v) for k, v in batch.items()}, None, 1.0)
    for k in ("ang_iso", "adv_loss", "clf_loss", "total_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=2e-3,
                                   err_msg=k)
    end = from_flax_train_state(jax.device_get(jst), 8)
    got = pst.state_dict()
    for name, opt in (("classifier", "clf_optimizer"),
                      ("classifier2", "clf2_optimizer")):
        for k, v in end[name].items():
            np.testing.assert_allclose(got[name][k].numpy(), v.numpy(),
                                       rtol=0, atol=2 * 2e-4,
                                       err_msg=f"{name} {k}")
        _assert_updates_match(got, end, ckpt, name, opt, 2e-4)


def test_new_modules_default_to_cuda_and_refuse_the_cpu(monkeypatch):
    """The device rule of the port's entry points: ``ChannelAugmenter``
    and ``ChannelClassifier`` default to the GPU and raise without one
    unless asked for the CPU."""
    from asvspoof2021_air_tpu_torch.ops.augment import ChannelAugmenter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ChannelAugmenter, lambda: ChannelClassifier(ENC, 4)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert ChannelAugmenter(device="cpu").tables["irs"].device.type == "cpu"
    assert next(ChannelClassifier(ENC, 4, device="cpu").parameters()
                ).device.type == "cpu"
