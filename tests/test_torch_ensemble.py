"""Ensembles on one card (``train/ensemble.py``) against the JAX package's
``train/ensemble.py``, on the CPU at small shapes (LCNN + ang_iso, as
tests/test_ensemble.py trains, B = 8): the ensemble step against the
members' own steps and against JAX's vmapped ensemble step with JAX's
per-member dropout masks injected and the weights carried across by
``interop/flax_weights``; the members' draws and divergence; eval scores
and ``fuse_scores``; ``train()`` with ``ensemble=2`` from feature files,
its checkpoint and resume, then ``cli.generate_score``'s member and fused
files; the ensemble with the on-the-fly front-end and the augmenter, K
steps per call, ADV_AUG and bf16; ``write_fused_score_file`` in both
layouts and ``--fusion wght``; a JAX ``ensemble=2`` run through
``tools/jax_checkpoint_to_torch.py``.

Tolerances: the ensemble step against independent member steps at
tests/test_ensemble.py's bars (rtol 2e-5, atol 2e-6; the port runs the
very same member steps, so it is bitwise in fact); against JAX's
ensemble step, per member, the port's trajectory bars
(tests/test_torch_train_families.py ``check_trajectory``: losses rtol
2e-3, parameters 2 lr K, updates by cosine and norm, Adam moments); eval
scores against the member eval steps 2e-5/2e-6; the fused file the mean
of the member files (rtol 1e-5, tests/test_ensemble.py's), the weighted
one rtol 1e-6; the converted JAX run's scores against the JAX CLI's
1e-4 (the port's scoring bar)."""

import copy
import dataclasses
import importlib.util
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
from asvspoof2021_air_tpu.losses import build_loss as j_build_loss
from asvspoof2021_air_tpu.train import ensemble as jens
from asvspoof2021_air_tpu.train import state as jstate
from asvspoof2021_air_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from asvspoof2021_air_tpu.train.steps import StepConfig as JStepConfig
from asvspoof2021_air_tpu.train.steps import make_train_step as j_make_step
from asvspoof2021_air_tpu_torch.cli import generate_score as p_cli
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_train_state)
from asvspoof2021_air_tpu_torch.losses.registry import build_loss
from asvspoof2021_air_tpu_torch.metrics.evaluate import (
    eer_from_score_file, read_score_file)
from asvspoof2021_air_tpu_torch.fusion import entropy_weights
from asvspoof2021_air_tpu_torch.train import ensemble as ens
from asvspoof2021_air_tpu_torch.train.checkpoint import restore_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import (
    TrainConfig, setup_training, train)
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import (
    MODEL_STREAM, StepConfig, make_eval_step, make_multi_step,
    make_train_step, step_generator)
from test_torch_scoring import shared_jax_make_score_fn
from test_torch_train import _write_part
from test_torch_train_families import (
    B, ENC, FRAMES, K, LR, WARM, _fast_jax_init, _write_features,
    check_trajectory, jax_model, port_draws, port_model, recorder)

M = 2
T = FRAMES["lcnn"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _batch(seed: int):
    g = np.random.default_rng(seed)
    labels = (np.arange(B) % 2).astype(np.int32)
    feat = g.standard_normal((B, T, 60)).astype(np.float32)
    return {"feat": feat + 0.5 * labels[:, None, None], "label": labels}


def _member(seed: int):
    """An LCNN + ang_iso member state with weights from ``seed``."""
    torch.manual_seed(seed)
    return create_train_state(
        port_model("lcnn", T),
        build_loss("ang_iso", enc_dim=ENC, r_real=0.9, r_fake=0.2,
                   alpha=20.0, device="cpu"),
        step_decay_schedule(LR, 0.5, 1, 2))


def _members():
    """Two member states of different weights (the port's LCNN draws its
    init from torch's global generator)."""
    return [_member(s) for s in (0, 1)]


def test_ensemble_step_equals_independent_members():
    """Member i after the ensemble step equals member i's own step from
    the same state with member i's draws: parameters, BN statistics, Adam
    state, the loss module and the metrics."""
    step = make_train_step(StepConfig(add_loss="ang_iso"), device="cpu")
    est = ens.init_ensemble_state(lambda i: _member(i), M)
    refs = _members()
    for r, m in zip(refs, est.members):
        r.load_state_dict(m.state_dict())
    e_step = ens.make_ensemble_train_step(step, M, mean_metrics=False)
    rng = 13
    for s in range(2):
        batch = {k: _t(v) for k, v in _batch(s).items()}
        metrics = e_step(est, batch, rng)
        for i, r in enumerate(refs):
            draws = step.draw_model(rng, r.step, r.model, batch, member=i)
            ref_m = step(r, batch, rng, model_draws=draws)
            for k, v in ref_m.items():
                np.testing.assert_allclose(float(metrics[k][i]), float(v),
                                           rtol=1e-5, err_msg=k)
    assert est.step == 2 and all(m.step == 2 for m in est.members)
    for i, r in enumerate(refs):
        got, want = est.members[i].state_dict(), r.state_dict()
        for k, w in want["model"].items():
            np.testing.assert_allclose(got["model"][k].numpy(), w.numpy(),
                                       rtol=2e-5, atol=2e-6, err_msg=k)
        for k, st in want["optimizer"].items():
            for name in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(
                    got["optimizer"][k][name].numpy(), st[name].numpy(),
                    rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got["loss_module"]["center"].numpy(),
                                   want["loss_module"]["center"].numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_member_draws_and_divergence():
    """Member i draws from (seed, step, MODEL_STREAM, i): the members'
    dropout masks differ; an ensemble of one draws what a single system
    draws, bit for bit; after three steps from states of different
    weights the members differ."""
    step = make_train_step(StepConfig(add_loss="ang_iso"), device="cpu")
    model = port_model("lcnn", T)
    batch = {k: _t(v) for k, v in _batch(0).items()}
    single = step.draw_model(5, 3, model, batch)
    one = ens.make_ensemble_train_step(step, 1).draw_model(
        5, 3, torch.nn.ModuleList([model]), batch)
    two = ens.make_ensemble_train_step(step, M).draw_model(
        5, 3, torch.nn.ModuleList([model, model]), batch)
    assert torch.equal(one[0], single)
    assert not torch.equal(two[0], two[1])
    assert torch.equal(two[1], model.draw(
        B, T, step_generator(5, 3, "cpu", MODEL_STREAM, 1)))
    est = ens.init_ensemble_state(lambda i: _member(i), M)
    e_step = ens.make_ensemble_train_step(step, M)
    for s in range(3):
        e_step(est, {k: _t(v) for k, v in _batch(s).items()}, 7)
    p0, p1 = (m.model.state_dict() for m in est.members)
    assert max(float((p0[k] - p1[k]).abs().max()) for k in p0) > 1e-3


@pytest.fixture(scope="module")
def jax_ensemble_trajectory():
    """WARM JAX ensemble steps (vmapped over M stacked LCNN + ang_iso
    members, Adam) from init, the members carried across by
    ``from_flax_train_state(member_state(...))``, then K steps in each
    package on the same batches, the port's given each member's JAX
    dropout masks (recorded under the member's split key)."""
    g = np.random.default_rng(0)
    labels = (np.arange(B) % 2).astype(np.int32)
    feats = g.standard_normal((WARM + K, B, T, 60)).astype(np.float32)
    feats += 0.5 * labels[None, :, None, None]
    model = jax_model("lcnn", T)
    loss_mod = j_build_loss("ang_iso", enc_dim=ENC, r_real=0.9, r_fake=0.2,
                            alpha=20.0)
    sched = jstate.step_decay_schedule(LR, 0.5, 1, 2)
    btx = jstate.make_backbone_optimizer(sched)
    ltx = jstate.make_loss_optimizer(sched)
    init = jax.jit(lambda r: jstate.create_train_state(
        r, model, jnp.asarray(feats[0]), loss_module=loss_mod,
        example_feat=jnp.zeros((B, ENC)),
        example_labels=jnp.asarray(labels), backbone_tx=btx, loss_tx=ltx))
    state = jens.init_ensemble_state(init, jax.random.PRNGKey(0), M)
    member_step = j_make_step(model, loss_mod, btx, ltx,
                              JStepConfig(add_loss="ang_iso"))
    step = jax.jit(jens.make_ensemble_train_step(member_step, M,
                                                 mean_metrics=False))
    record = recorder(model)
    key = jax.random.PRNGKey(1)
    batch = lambda s: {"feat": jnp.asarray(feats[s]),
                       "label": jnp.asarray(labels)}
    for s in range(WARM):
        state, _ = step(state, batch(s), key)
    host = jax.device_get(state)
    start = [from_flax_train_state(jens.member_state(host, i), model="lcnn")
             for i in range(M)]
    j_metrics, draws = [], []
    rngs = jax.random.split(key, M)
    for s in range(WARM, WARM + K):
        step_no = int(np.asarray(state.step)[0])
        draws.append([np.array(record(
            {"params": jax.tree.map(lambda x: x[i], state.params),
             "batch_stats": jax.tree.map(lambda x: x[i],
                                         state.batch_stats)},
            jnp.asarray(feats[s]), jax.random.fold_in(rngs[i], step_no)))
            for i in range(M)])
        state, m = step(state, batch(s), key)
        j_metrics.append({k: np.asarray(v) for k, v in m.items()})
    host = jax.device_get(state)
    end = [from_flax_train_state(jens.member_state(host, i), model="lcnn")
           for i in range(M)]

    est = ens.init_ensemble_state(lambda i: _member(i), M)
    est.load_state_dict({"step": WARM, "members": start})
    p_step = ens.make_ensemble_train_step(
        make_train_step(StepConfig(add_loss="ang_iso"), device="cpu"), M,
        mean_metrics=False)
    p_metrics = []
    for i, s in enumerate(range(WARM, WARM + K)):
        m = p_step(est, {"feat": _t(feats[s]), "label": _t(labels)},
                   model_draws=[port_draws("lcnn", d) for d in draws[i]])
        p_metrics.append({k: v.numpy() for k, v in m.items()})
    got = est.state_dict()["members"]
    return [dict(start=start[i], end=end[i], got=got[i],
                 j_metrics=[{k: float(v[i]) for k, v in m.items()}
                            for m in j_metrics],
                 p_metrics=[{k: float(v[i]) for k, v in m.items()}
                            for m in p_metrics])
            for i in range(M)]


@pytest.mark.parametrize("member", range(M))
def test_ensemble_step_tracks_jax_ensemble_step(jax_ensemble_trajectory,
                                                member):
    t = jax_ensemble_trajectory[member]
    check_trajectory(t, "ang_iso")
    other = jax_ensemble_trajectory[1 - member]
    assert not torch.equal(t["got"]["model"]["fc_mu.weight"],
                           other["got"]["model"]["fc_mu.weight"])


def test_ensemble_eval_scores_and_fusion():
    """The ensemble eval step returns (M, B) scores equal to each member's
    eval step, member-averaged metrics and member 0's embeddings;
    ``fuse_scores`` is the mean over the members."""
    est = ens.init_ensemble_state(lambda i: _member(i), M)
    eval_step = make_eval_step(StepConfig(add_loss="ang_iso"), device="cpu")
    e_eval = ens.make_ensemble_eval_step(eval_step)
    batch = {k: _t(v) for k, v in _batch(5).items()}
    metrics, scores, feats = e_eval(est, batch)
    assert scores.shape == (M, B) and feats.shape == (B, ENC)
    ms = []
    for i, member in enumerate(est.members):
        m, s, f = eval_step(member, batch)
        np.testing.assert_allclose(scores[i].numpy(), s.numpy(), rtol=2e-5,
                                   atol=2e-6)
        ms.append(m)
        if i == 0:
            assert torch.equal(feats, f)
    for k in metrics:
        assert metrics[k].shape == ()
        np.testing.assert_allclose(float(metrics[k]),
                                   np.mean([float(m[k]) for m in ms]),
                                   rtol=1e-6)
    np.testing.assert_allclose(ens.fuse_scores(scores.numpy()),
                               scores.numpy().mean(0))


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ens") / "feats")
    _write_features(root, "train", 16, 0, T)
    _write_features(root, "dev", 8, 1, T)
    return root


def test_train_loop_checkpoint_resume_and_scoring(tmp_path, feats,
                                                  monkeypatch):
    """``train()`` with ``ensemble=2`` from feature files for 2 epochs:
    one checkpoint holds both members and the shared step; ``auto_resume``
    restores them all to a third epoch; then ``cli.generate_score``
    writes each member's file and the fused file, their mean (rtol
    1e-5) in the single-system layout, and ``--fusion wght`` the members
    weighted by their EERs' entropy weights (rtol 1e-6), also on a tree
    without class signal, where the members' EERs and weights differ."""
    out = tmp_path / "runs" / "run"
    cfg = TrainConfig(out_fold=str(out), path_to_features=feats,
                      model="lcnn", add_loss="ang_iso", num_epochs=2,
                      batch_size=B, feat_len=T, enc_dim=ENC, ratio=1.0,
                      ensemble=M, seed=3, auto_resume=True)
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    ckpt = restore_checkpoint(str(out / "checkpoint" / "2.pt"))
    assert ckpt["step"] == 4 and len(ckpt["members"]) == M
    live = state.state_dict()
    for i in range(M):
        for k, v in live["members"][i]["model"].items():
            assert torch.equal(ckpt["members"][i]["model"][k], v), k
    summary3, state3 = train(dataclasses.replace(cfg, num_epochs=3),
                             device="cpu", return_state=True)
    assert summary3["epochs"] == 3 and state3.step == 6
    with open(out / "train_loss.log") as f:
        assert len(f.readlines()[1:]) == 6

    monkeypatch.chdir(tmp_path)
    base = ["--model_folder", str(tmp_path / "runs"), "-n", "run", "-t",
            "19dev", "--ori_features", feats, "--batch_size", "4",
            "--device", "cpu"]
    fused = p_cli.main(base)
    scores = tmp_path / "scores"
    members = [str(scores / f"run_member{i}_19dev_score.txt")
               for i in range(M)]
    f, m0, m1 = (read_score_file(p) for p in [fused] + members)
    assert f["key"] is not None and f["sysid"] is None
    assert np.array_equal(f["fname"], m0["fname"])
    np.testing.assert_allclose(f["score"], (m0["score"] + m1["score"]) / 2,
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(m0["score"], m1["score"])
    fused_w = p_cli.main(base + ["--fusion", "wght"])
    w = entropy_weights([eer_from_score_file(p) for p in members])
    ref = p_cli.write_fused_score_file(members, str(tmp_path / "ref.txt"),
                                       w)
    np.testing.assert_allclose(read_score_file(fused_w)["score"],
                               read_score_file(ref)["score"], rtol=1e-6)
    # the members' EERs may be equal on that tree, and their weights with
    # them: on 32 files without class signal they differ
    noise = tmp_path / "noise"
    (noise / "dev" / "LFCC").mkdir(parents=True)
    g = np.random.default_rng(9)
    for i in range(32):
        tag = "A01_spoof" if i % 2 else "-_bonafide"
        np.save(noise / "dev" / "LFCC" / f"{i:06d}_LA_T_{1000000 + i}_{tag}"
                ".npy", g.standard_normal((1, T, 60)).astype(np.float32))
    base[base.index(feats)] = str(noise)
    fused_w = p_cli.main(base + ["--fusion", "wght"])
    eers = [eer_from_score_file(p) for p in members]
    w = entropy_weights(eers)
    assert eers[0] != eers[1] and w[0] != w[1], (eers, w)
    ref = p_cli.write_fused_score_file(members, str(tmp_path / "ref.txt"),
                                       w)
    np.testing.assert_allclose(read_score_file(fused_w)["score"],
                               read_score_file(ref)["score"], rtol=1e-6)


def test_write_fused_score_file_layouts(tmp_path):
    """The fused file keeps the members' layout: 3 columns for labeled
    tasks, 2 for the challenge tasks (nested directories made); members
    of another trial order are refused."""
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text("f1 0.5 bonafide\nf2 -0.5 spoof\n")
    b.write_text("f1 0.7 bonafide\nf2 -0.1 spoof\n")
    out = tmp_path / "fused" / "labeled.txt"
    p_cli.write_fused_score_file([str(a), str(b)], str(out))
    assert out.read_text() == "f1 0.6 bonafide\nf2 -0.3 spoof\n"
    c, d = tmp_path / "c.txt", tmp_path / "d.txt"
    c.write_text("f1 1.0\nf2 2.0\n")
    d.write_text("f1 3.0\nf2 4.0\n")
    out2 = tmp_path / "deep" / "nested" / "score.txt"
    p_cli.write_fused_score_file([str(c), str(d)], str(out2))
    assert out2.read_text() == "f1 2.0\nf2 3.0\n"
    e = tmp_path / "e.txt"
    e.write_text("f2 1.0\nf1 2.0\n")
    with pytest.raises(ValueError, match="order"):
        p_cli.write_fused_score_file([str(c), str(e)], str(tmp_path / "x"))


def test_on_the_fly_with_the_augmenter_and_k_steps(tmp_path, monkeypatch):
    """``ensemble=2`` on the fly with the channel augmenter, two steps per
    call, bf16: the front-end runs once a step over the (M B)-row tiled
    batch, member-major, the augmenter drawing for M B rows; K steps per
    call equal K single ensemble steps bitwise; the dev pass scores both
    members."""
    from asvspoof2021_air_tpu_torch.train import frontend as fe_mod

    db = str(tmp_path / "db")
    _write_part(db, "train", 8, 0, 7000)
    _write_part(db, "dev", 8, 1, 7000)
    calls = []
    orig = fe_mod.OnDeviceFrontend.__call__

    def spy(self, batch, rng=None, params=None):
        calls.append((tuple(batch["wave"].shape), self.augmenter is not None,
                      None if rng is None else tuple(rng["noise"].shape)))
        return orig(self, batch, rng, params)

    monkeypatch.setattr(fe_mod.OnDeviceFrontend, "__call__", spy)
    cfg = TrainConfig(out_fold=str(tmp_path / "o"), path_to_database=db,
                      on_the_fly=True, on_device_aug=True, model="lcnn",
                      add_loss="ang_iso", enc_dim=ENC, feat_len=T,
                      batch_size=B, num_epochs=1, ratio=1.0, ensemble=M,
                      steps_per_call=2, compute_dtype="bfloat16")
    summary = train(cfg, device="cpu")
    assert summary["epochs"] == 1 and np.isfinite(summary["dev_loss"])
    L = (T - 1) * 160
    train_calls = [c for c in calls if c[1]]
    assert train_calls and all(c == ((M * B, L), True, (M * B, L))
                               for c in train_calls)
    assert any(c[0] == (B, L) and not c[1] for c in calls)   # dev, clean

    _, _, st, step, _ = setup_training(cfg, 2, frontend=fe_mod.
                                       OnDeviceFrontend(
                                           feat_len=T, device="cpu"),
                                       device="cpu")
    g = np.random.default_rng(4)
    waves = {"wave": _t(g.standard_normal((2, B, L)).astype(np.float32)),
             "length": _t(np.full((2, B), L, np.int64)),
             "label": _t(np.tile(np.arange(B) % 2, (2, 1)))}
    init = copy.deepcopy(st.state_dict())
    multi = make_multi_step(step, 2)(st, waves, 9)
    after_multi = st.state_dict()
    st.load_state_dict(init)
    single = [step(st, {k: v[i] for k, v in waves.items()}, 9)
              for i in range(2)]
    for k, v in multi.items():
        assert torch.equal(v, torch.stack([s[k] for s in single])), k
    for a, b in zip(after_multi["members"], st.state_dict()["members"]):
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), k


def test_on_the_fly_members_train_on_their_rows():
    """On the fly with the channel augmenter, member i's ensemble step
    equals a single-system step from member i's state on rows i B ..
    (i + 1) B - 1 of the features of the batch tiled M times member-major,
    with the augmenter's draws for the M B rows from (seed, step) and
    member i's dropout from (seed, step, MODEL_STREAM, i), each made here
    and not by the ensemble step (tests/test_ensemble.py's bars, rtol
    2e-5, atol 2e-6). The augmenter draws per row, so the members' rows
    differ: a member given another member's rows, or the rows
    interleaved, fails."""
    from asvspoof2021_air_tpu_torch.ops.augment import ChannelAugmenter
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

    L, rng = (T - 1) * 160, 5
    fe = OnDeviceFrontend(feat_len=T, augmenter=ChannelAugmenter(
        device="cpu"), device="cpu")
    step = make_train_step(StepConfig(add_loss="ang_iso"), frontend=fe,
                           device="cpu")
    e_step = ens.make_ensemble_train_step(step, M, mean_metrics=False,
                                          frontend=fe)
    g = np.random.default_rng(6)
    batch = {"wave": _t(0.1 * g.standard_normal((B, L)).astype(np.float32)),
             "length": _t(np.full(B, L, np.int64)),
             "label": _t((np.arange(B) % 2).astype(np.int64))}
    est = ens.init_ensemble_state(_member, M)
    start = copy.deepcopy(est.state_dict())
    draws = fe.augmenter.draw((M * B, L), step_generator(rng, 0, "cpu"))
    with torch.no_grad():
        x = fe({k: torch.cat([batch[k]] * M) for k in ("wave", "length")},
               draws)
    rows = [x[i * B:(i + 1) * B] for i in range(M)]
    assert x.shape == (M * B, T, 60) and not torch.equal(rows[0], rows[1])
    metrics = e_step(est, batch, rng)
    close = lambda a, b, what: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6, err_msg=what)
    for i in range(M):
        single = _member(i)
        single.load_state_dict(start["members"][i])
        m = step(single, {"feat": rows[i], "label": batch["label"]},
                 model_draws=single.model.draw(B, T, step_generator(
                     rng, 0, "cpu", MODEL_STREAM, i)))
        for k, v in m.items():
            close(metrics[k][i], v, f"member {i} {k}")
        got, want = est.members[i].state_dict(), single.state_dict()
        for k, w in want["model"].items():
            close(got["model"][k], w, f"member {i} {k}")
        close(got["loss_module"]["center"], want["loss_module"]["center"],
              f"member {i} center")


def test_adv_aug_ensemble(tmp_path):
    """``ensemble=2`` with ADV_AUG from LA_aug feature files: each member
    has its own channel classifier and Adam; both classifiers move, and
    the members' classifiers differ."""
    ori, aug = str(tmp_path / "ori"), str(tmp_path / "aug")
    for root, sfx in ((ori, ""), (aug, "aug")):
        _write_features(root, "train", 8, 4, T, sfx)
        _write_features(root, "dev", 8, 5, T, sfx)
    cfg = TrainConfig(out_fold=str(tmp_path / "out"), path_to_features=ori,
                      path_to_aug_features=aug, LA_aug=True, ADV_AUG=True,
                      model="lcnn", add_loss="ang_iso", batch_size=B,
                      feat_len=T, enc_dim=ENC, num_epochs=2, ratio=0.5,
                      ensemble=M)
    init = setup_training(cfg, 2, device="cpu")[2].state_dict()
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    live = state.state_dict()["members"]
    for i in range(M):
        for k, v in live[i]["classifier"].items():
            assert not torch.equal(v, init["members"][i]["classifier"][k])
        assert live[i]["clf_optimizer"]
    w0, w1 = (live[i]["classifier"]["classifier.0.weight"] for i in range(M))
    assert not torch.equal(w0, w1)


def test_jax_ensemble_run_through_the_converter(tmp_path, monkeypatch):
    """A JAX ``ensemble=2`` LCNN + ang_iso run (its stacked state),
    converted by ``tools/jax_checkpoint_to_torch.py``: the port's
    checkpoint holds both members, split off the stacked axis by the JAX
    ``member_state``; the port's ``cli.generate_score`` writes member and
    fused files within 1e-4 of the JAX CLI's."""
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                     "jax_checkpoint_to_torch.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    _fast_jax_init(monkeypatch)
    monkeypatch.setattr(jscoring, "make_score_fn", shared_jax_make_score_fn)
    feats = str(tmp_path / "feats")
    _write_features(feats, "dev", 8, 1, T)
    runs = tmp_path / "runs"
    jcfg = jloop.TrainConfig(out_fold=str(runs / "jax"), model="lcnn",
                             add_loss="ang_iso", enc_dim=ENC, feat_len=T,
                             ensemble=M)
    state = jloop.setup_training(jcfg, steps_per_epoch=1)[2]
    os.makedirs(runs / "jax")
    with open(runs / "jax" / "args.json", "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    j_save_checkpoint(str(runs / "jax" / "best"), state)
    converter.main(["--model_dir", str(runs / "jax"), "--out",
                    str(runs / "port")])
    ckpt = torch.load(runs / "port" / "best.pt", weights_only=True)
    assert len(ckpt["members"]) == M
    sds, losses, pcfg = p_cli.load_system(str(runs / "port"), device="cpu")
    assert pcfg.ensemble == M and len(sds) == len(losses) == M
    assert not torch.equal(sds[0]["fc_mu.weight"], sds[1]["fc_mu.weight"])

    monkeypatch.chdir(tmp_path)
    args = ["--model_folder", str(runs), "-t", "19dev", "--batch_size", "4",
            "--ori_features", feats]
    j_cli.main(["-n", "jax", *args])
    p_cli.main(["-n", "port", "--device", "cpu", *args])
    for suffix in ("_member0", "_member1", ""):
        got = read_score_file(str(tmp_path / "scores" /
                                  f"port{suffix}_19dev_score.txt"))
        want = read_score_file(str(tmp_path / "scores" /
                                   f"jax{suffix}_19dev_score.txt"))
        assert np.array_equal(got["fname"], want["fname"])
        np.testing.assert_allclose(got["score"], want["score"], rtol=0,
                                   atol=1e-4, err_msg=suffix)
