"""The port's training loop beyond one f32 step per call on the fly, on the
CPU at small shapes: training from cached (and augmented) feature files,
K steps per call, resume, the eval-set EER, profiling, and the CLI's flags
for them, each against the JAX loop's behaviour."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import asvspoof2021_air_tpu.train.loop as jloop
from asvspoof2021_air_tpu_torch.cli.train import config_from_args
from asvspoof2021_air_tpu_torch.cli.train import parse_args as cli_parse_args
from asvspoof2021_air_tpu_torch.data.datasets import (
    ASVspoof2019FeatureDataset, RawAudioDataset)
from asvspoof2021_air_tpu_torch.data.pipeline import pad_or_crop
from asvspoof2021_air_tpu_torch.metrics.eer import compute_eer
from asvspoof2021_air_tpu_torch.train.loop import (
    TrainConfig, check_supported, setup_training, train)
from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

from test_torch_train import _jax_summary_keys, _write_part
from torch_threads import one_thread  # noqa: F401

C, SCALE, ENC, B, T = 32, 4, 16, 8, 40
CHANNEL = "amr[br=5k9]"


def _write_features(root, part, n, seed, suffix=""):
    """n (1, T', 60) LFCC-shaped .npy files named as the reference cache
    names them; spoof items shifted so the classes separate; T' around T
    (some cropped, some repeat-padded)."""
    d = os.path.join(root, part, "LFCC")
    os.makedirs(d)
    g = np.random.default_rng(seed)
    for i in range(n):
        label = i % 2
        x = g.standard_normal((1, T + 3 * (i % 5) - 6, 60)) + 0.7 * label
        name = (f"{i:06d}_LA_T_{1000000 + i}_{'A01' if label else '-'}_"
                f"{'spoof' if label else 'bonafide'}{suffix}")
        np.save(os.path.join(d, name + ".npy"), x.astype(np.float32))


@pytest.fixture(scope="module")
def feature_trees(tmp_path_factory):
    """ori/{train,dev,eval}/LFCC and aug/{train,dev}/LFCC (one LA
    channel)."""
    root = tmp_path_factory.mktemp("feats")
    ori, aug = str(root / "ori"), str(root / "aug")
    for part, n, seed in (("train", 24, 0), ("dev", 8, 1), ("eval", 10, 2)):
        _write_features(ori, part, n, seed)
    for part, n, seed in (("train", 16, 3), ("dev", 8, 4)):
        _write_features(aug, part, n, seed, f"_{CHANNEL}")
    return ori, aug


def _config(tmp_path, ori, aug="", **kw):
    return TrainConfig(**{**dict(
        out_fold=str(tmp_path / "out"), path_to_features=ori,
        path_to_aug_features=aug, model="ecapa", add_loss="ang_iso",
        batch_size=B, feat_len=T, num_epochs=2, C=C, model_scale=SCALE,
        enc_dim=ENC), **kw})


def _log(out, name):
    with open(os.path.join(out, name)) as f:
        return [line.split() for line in f.readlines()[1:]]


@pytest.mark.parametrize("aug", [False, True])
def test_train_from_feature_files(tmp_path, feature_trees, aug):
    """Two epochs from a plain feature tree (ratio 1: 3 steps an epoch) and
    from an LA_aug tree (ratio 0.5, 4 originals a batch: 6 steps): the
    summary has the JAX train's keys, the logs one line per step and per
    epoch, the checkpoints are written and the state moved."""
    ori, augp = feature_trees
    cfg = _config(tmp_path, ori, augp if aug else "", LA_aug=aug,
                  ratio=0.5 if aug else 1.0)
    summary, state = train(cfg, device="cpu", return_state=True)
    assert set(summary) == _jax_summary_keys()
    spe = 6 if aug else 3
    assert summary["epochs"] == 2 and state.step == 2 * spe
    assert np.isfinite(summary["dev_loss"]) and 0 <= summary["dev_eer"] <= 1
    rows = _log(cfg.out_fold, "train_loss.log")
    assert [(int(r[0]), int(r[1])) for r in rows] == [
        (e, i) for e in range(2) for i in range(spe)]
    assert all(np.isfinite(float(r[2])) for r in rows)
    assert len(_log(cfg.out_fold, "dev_loss.log")) == 2
    for name in ("best.pt", "train_meta.json",
                 os.path.join("checkpoint", "2.pt")):
        assert os.path.exists(os.path.join(cfg.out_fold, name)), name


def test_no_data_raises_the_jax_message(tmp_path):
    """The JAX loop's FileNotFoundError text, with the port's own
    preprocessing CLI named where JAX names its own."""
    empty = str(tmp_path / "none")
    msgs = []
    for mod, out in ((jloop, "j"), (None, "p")):
        kw = dict(out_fold=str(tmp_path / out), path_to_features=empty,
                  model="ecapa")
        with pytest.raises(FileNotFoundError) as e:
            if mod is None:
                train(TrainConfig(**kw), device="cpu")
            else:
                jloop.train(jloop.TrainConfig(**kw))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0].replace(
        "asvspoof2021_air_tpu.cli.preprocess",
        "asvspoof2021_air_tpu_torch.cli.preprocess")
    assert "no data found under" in msgs[1]
    assert "run asvspoof2021_air_tpu_torch.cli.preprocess" in msgs[1]


def test_multi_step_equals_single_steps_bitwise():
    """make_multi_step(K=2) on the CPU: the same metrics, parameters,
    statistics and Adam state as two single steps, bit for bit."""
    cfg = TrainConfig(model="ecapa", add_loss="ang_iso", batch_size=B,
                      feat_len=T, C=C, model_scale=SCALE, enc_dim=ENC)
    g = np.random.default_rng(3)
    batches = [{"feat": torch.from_numpy(
        g.standard_normal((B, T, 60)).astype(np.float32)),
        "label": torch.from_numpy((np.arange(B) % 2).astype(np.int32))}
        for _ in range(2)]
    runs = []
    for multi in (False, True):
        _, _, state, step, _ = setup_training(cfg, 4, device="cpu")
        if multi:
            m = make_multi_step(step, 2)(state, {
                k: torch.stack([b[k] for b in batches]) for k in batches[0]})
        else:
            ms = [step(state, b) for b in batches]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((m, state.state_dict()))
    (m1, s1), (m2, s2) = runs
    assert sorted(m1) == sorted(m2) and all(v.shape == (2,)
                                            for v in m2.values())
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert s1["step"] == s2["step"] == 2
    for part in ("model", "loss_module"):
        for k, v in s1[part].items():
            assert torch.equal(v, s2[part][k]), k
    for name, st in s1["optimizer"].items():
        for k, v in st.items():
            assert torch.equal(v, s2["optimizer"][name][k]), (name, k)


def test_steps_per_call_logs_every_step(tmp_path, feature_trees):
    """steps_per_call=2 over 3 steps an epoch (a call of 2 and a tail of
    1): one log line per step, numbered as tests/test_train_loop.py:332-356
    numbers the JAX loop's."""
    ori, _ = feature_trees
    cfg = _config(tmp_path, ori, ratio=1.0, steps_per_call=2)
    summary = train(cfg, device="cpu")
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    steps = [int(r[1]) for r in _log(cfg.out_fold, "train_loss.log")]
    assert steps == [0, 1, 2, 0, 1, 2]


def test_steps_per_call_refuses_variable_length_batches(tmp_path,
                                                        feature_trees):
    ori, _ = feature_trees
    with pytest.raises(ValueError, match="pad_chop"):
        train(_config(tmp_path, ori, steps_per_call=2, pad_chop=False),
              device="cpu")
    # one step per call collates each batch to its own length, as JAX does
    summary = train(_config(tmp_path, ori, ratio=1.0, pad_chop=False,
                            num_epochs=1), device="cpu")
    assert np.isfinite(summary["dev_loss"])


def test_continue_training_keeps_the_run_and_loads_best(tmp_path,
                                                        feature_trees):
    """continue_training keeps the run folder and its logs and restarts
    from best.pt (not from a fresh init), as the JAX loop does."""
    ori, _ = feature_trees
    cfg = _config(tmp_path, ori, ratio=1.0, num_epochs=1)
    train(cfg, device="cpu")
    best = torch.load(os.path.join(cfg.out_fold, "best.pt"),
                      weights_only=True)
    before = _log(cfg.out_fold, "train_loss.log")
    cont = dataclasses.replace(cfg, continue_training=True, num_epochs=0)
    _, state = train(cont, device="cpu", return_state=True)
    assert state.step == best["step"] == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, best["model"][k]), k
    assert _log(cfg.out_fold, "train_loss.log") == before
    summary = train(dataclasses.replace(cont, num_epochs=1), device="cpu")
    assert summary["epochs"] == 1
    assert len(_log(cfg.out_fold, "train_loss.log")) == 2 * len(before)


def test_auto_resume_starts_at_the_newest_epoch(tmp_path, feature_trees):
    """A restart with more epochs resumes at the newest epoch checkpoint
    (tests/test_train_loop.py:188-211 for JAX): the step count carries
    over and only the new epoch runs."""
    ori, _ = feature_trees
    cfg = _config(tmp_path, ori, ratio=1.0, auto_resume=True)
    s1 = train(cfg, device="cpu")
    assert s1["epochs"] == 2
    s2, state = train(dataclasses.replace(cfg, num_epochs=3), device="cpu",
                      return_state=True)
    assert s2["epochs"] == 3 and state.step == 9
    assert sorted(os.listdir(os.path.join(cfg.out_fold, "checkpoint"))) == [
        "1.pt", "2.pt", "3.pt"]
    rows = _log(cfg.out_fold, "train_loss.log")
    assert [int(r[0]) for r in rows] == [0] * 3 + [1] * 3 + [2] * 3


def test_auto_resume_keeps_best_dev_loss_and_early_stop(tmp_path,
                                                        feature_trees):
    """After a resume, best.pt is not overwritten by a dev loss worse than
    the recorded best, and the early-stop count continues
    (tests/test_train_loop.py:214-266 for JAX)."""
    ori, _ = feature_trees
    cfg = _config(tmp_path, ori, ratio=1.0, auto_resume=True, num_epochs=1)
    s1 = train(cfg, device="cpu")
    meta_path = os.path.join(cfg.out_fold, "train_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["best_dev_loss"] == s1["best_dev_loss"]
    with open(meta_path, "w") as f:
        json.dump({**meta, "best_dev_loss": 1e-9, "early_stop": 3}, f)
    best = os.path.join(cfg.out_fold, "best.pt")
    mtime = os.path.getmtime(best)
    s2 = train(dataclasses.replace(cfg, num_epochs=2), device="cpu")
    assert s2["best_dev_loss"] == 1e-9
    assert os.path.getmtime(best) == mtime
    with open(meta_path) as f:
        assert json.load(f)["early_stop"] == 4


def _direct_eer(state, eval_step, batches):
    """EER of the eval step's scores over ``batches`` of (batch dict, row
    count): the scoring the loop's test_on_eval must reproduce."""
    scores, labels = [], []
    for batch, n in batches:
        _, score, _ = eval_step(state, batch)
        scores.append(score.numpy()[:n])
        labels.append(batch["label"].numpy()[:n])
    s, lab = np.concatenate(scores), np.concatenate(labels)
    return min(compute_eer(s[lab == 0], s[lab == 1])[0],
               compute_eer(-s[lab == 0], -s[lab == 1])[0])


def test_test_on_eval_from_features(tmp_path, feature_trees):
    """With an eval set, each epoch appends ``epoch\\teer`` to
    test_loss.log; the last one equals the EER of the final state scored
    directly, all 10 eval items in one batch."""
    ori, _ = feature_trees
    cfg = _config(tmp_path, ori, ratio=1.0, test_on_eval=True)
    eval_set = ASVspoof2019FeatureDataset("LA", ori, "eval")
    _, state = train(cfg, eval_set=eval_set, device="cpu",
                     return_state=True)
    rows = _log(cfg.out_fold, "test_loss.log")
    assert [r[0] for r in rows] == ["0", "1"]
    items = [eval_set[i] for i in range(len(eval_set))]
    batch = {"feat": torch.from_numpy(np.concatenate(
        [pad_or_crop(f, T, "repeat") for f, *_ in items])),
        "label": torch.tensor([it[3] for it in items])}
    eval_step = setup_training(cfg, 3, device="cpu")[4]
    assert float(rows[-1][1]) == pytest.approx(
        _direct_eer(state, eval_step, [(batch, len(items))]), abs=1e-12)


def test_test_on_eval_on_the_fly(tmp_path):
    """On the fly: sequential waveform batches, the wrapped tail trimmed by
    count (10 eval items in batches of 8); the EER equals scoring the
    same waveforms directly."""
    db = str(tmp_path / "db")
    for part, n, seed in (("train", 8, 0), ("dev", 8, 1), ("eval", 10, 2)):
        _write_part(db, part, n, seed, 7000)
    cfg = TrainConfig(out_fold=str(tmp_path / "out"), path_to_database=db,
                      model="ecapa", add_loss="ang_iso", on_the_fly=True,
                      batch_size=B, feat_len=T, num_epochs=1, C=C,
                      model_scale=SCALE, enc_dim=ENC, ratio=1.0,
                      test_on_eval=True)
    eval_set = RawAudioDataset("LA", db, "eval")
    _, state = train(cfg, eval_set=eval_set, device="cpu",
                     return_state=True)
    rows = _log(cfg.out_fold, "test_loss.log")
    assert [r[0] for r in rows] == ["0"]
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

    fe = OnDeviceFrontend(feat_len=T, device="cpu")
    eval_step = setup_training(cfg, 1, frontend=fe, device="cpu")[4]
    n = fe.min_samples()
    items = [eval_set[i] for i in range(len(eval_set))]
    wave = np.zeros((len(items), n), np.float32)
    for r, it in enumerate(items):
        w = np.asarray(it[0], np.float32)[:n]
        wave[r, :len(w)] = w
    batch = {"wave": torch.from_numpy(wave),
             "length": torch.tensor([min(len(it[0]), n) for it in items]),
             "label": torch.tensor([it[3] for it in items])}
    assert float(rows[0][1]) == pytest.approx(
        _direct_eer(state, eval_step, [(batch, len(items))]), abs=1e-12)


def test_profile_writes_a_trace(tmp_path, feature_trees):
    ori, _ = feature_trees
    cfg = _config(tmp_path, ori, ratio=1.0, profile=True, num_epochs=1)
    train(cfg, device="cpu")
    trace = os.path.join(cfg.out_fold, "profile", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_cli_takes_the_jax_flags(tmp_path):
    """The JAX CLI's flags for this slice, on the command line and in a JAX
    ``--config`` file, reach TrainConfig; check_supported lets them
    through, CQCC on the fly among them, and refuses STFT on the fly as the
    JAX front-end does."""
    args = ["-o", str(tmp_path / "o"), "-f", "/feats",
            "--path_to_aug_features", "/aug", "--pad_chop", "false",
            "--LA_aug", "--compute_dtype", "bfloat16", "--steps_per_call",
            "8", "--continue_training", "--auto_resume", "--test_on_eval",
            "--profile"]
    cfg = config_from_args(cli_parse_args(args))
    assert (cfg.path_to_features, cfg.path_to_aug_features, cfg.pad_chop,
            cfg.LA_aug, cfg.compute_dtype, cfg.steps_per_call,
            cfg.continue_training, cfg.auto_resume, cfg.test_on_eval,
            cfg.profile, cfg.on_the_fly) == (
        "/feats", "/aug", False, True, "bfloat16", 8, True, True, True,
        True, False)
    check_supported(dataclasses.replace(cfg, model="ecapa"))
    jcfg = dataclasses.asdict(jloop.TrainConfig(
        model="ecapa", path_to_features="/f", DF_aug=True,
        compute_dtype="bfloat16", steps_per_call=4, auto_resume=True,
        feat="CQCC"))
    path = tmp_path / "args.json"
    path.write_text(json.dumps(jcfg))
    cfg = config_from_args(cli_parse_args(["-o", str(tmp_path / "o"),
                                           "--config", str(path)]))
    assert (cfg.path_to_features, cfg.DF_aug, cfg.compute_dtype,
            cfg.steps_per_call, cfg.auto_resume, cfg.feat) == (
        "/f", True, "bfloat16", 4, True, "CQCC")
    check_supported(cfg)
    # CQCC on the fly is ported (tests/test_torch_cqcc.py); STFT and
    # Melspec on the fly are refused with the JAX front-end's ValueError
    check_supported(dataclasses.replace(cfg, on_the_fly=True))
    with pytest.raises(ValueError, match="LFCC/CQCC"):
        check_supported(dataclasses.replace(cfg, on_the_fly=True,
                                            feat="STFT"))
