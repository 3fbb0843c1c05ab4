"""Port scoring slice against the JAX package: the OC-Softmax loss and
score, the front-end's padding policies, and waveform -> score file end to
end on a synthetic corpus (f32 on the CPU)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.data.audio_io import write_wav
from asvspoof2021_air_tpu.data.datasets import RawAudioDataset as JRawDataset
from asvspoof2021_air_tpu.losses.one_class import OCSoftmax as JOCSoftmax
from asvspoof2021_air_tpu.metrics import eer_from_score_file as j_eer
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.scoring import score_raw_to_file as j_score_raw
from asvspoof2021_air_tpu.scoring import score_rule as j_score_rule
from asvspoof2021_air_tpu.train.frontend import OnDeviceFrontend as JFrontend
from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
from asvspoof2021_air_tpu_torch.interop.flax_weights import from_flax_variables
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.metrics.eer import eer_from_score_file
from asvspoof2021_air_tpu_torch.scoring import score_raw_to_file, score_rule
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

ENC = 32


def _oc_pair(center, **kw):
    port = OCSoftmax(feat_dim=center.shape[1], **kw, device="cpu")
    with torch.no_grad():
        port.center.copy_(torch.from_numpy(center))
    return JOCSoftmax(feat_dim=center.shape[1], **kw), port


def test_ocsoftmax_loss_and_score_match_jax():
    g = np.random.default_rng(0)
    center = g.uniform(-2, 2, (1, ENC)).astype(np.float32)
    emb = g.standard_normal((16, ENC)).astype(np.float32)
    labels = (np.arange(16) % 2).astype(np.int32)
    jmod, port = _oc_pair(center, r_real=0.9, r_fake=0.2, alpha=20.0)
    want_loss, want_score = jmod.apply(
        {"params": {"center": jnp.asarray(center)}}, jnp.asarray(emb),
        jnp.asarray(labels))
    loss, score = port(torch.from_numpy(emb), torch.from_numpy(labels))
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(want_score),
                               atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)


def test_default_score_rule_and_unported_rules():
    """The default rule, -softmax(logits)[:, 0], for None and, as in the
    JAX ``score_rule``, for a rule name it does not know; every named rule
    is ported (tests/test_torch_loss_rules.py)."""
    logits = np.random.default_rng(1).standard_normal((5, 2)).astype(
        np.float32)
    for rule in (None, "center"):
        want = j_score_rule(rule, None, jnp.asarray(logits))
        got = score_rule(rule, torch.zeros(5, ENC), torch.from_numpy(logits))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("padding", ["repeat", "zero", "silence"])
def test_frontend_padding_matches_jax(padding):
    feat_len = 40
    g = np.random.default_rng(2)
    wave = (0.3 * g.standard_normal((3, 7000))).astype(np.float32)
    lengths = np.array([7000, 3000, 900], np.int32)
    jfe = JFrontend(feat_len=feat_len, padding=padding, use_pallas=False)
    want = np.asarray(jfe({"wave": jnp.asarray(wave),
                           "length": jnp.asarray(lengths)},
                          jax.random.PRNGKey(0)))
    fe = OnDeviceFrontend(feat_len=feat_len, padding=padding, device="cpu")
    got = fe({"wave": torch.from_numpy(wave),
              "length": torch.from_numpy(lengths)}).numpy()
    assert got.shape == want.shape == (3, feat_len, 60)
    np.testing.assert_allclose(got, want, atol=5e-4)


def _corpus(root, lengths, seed=0):
    """ASVspoof2019-layout wav corpus: bona fide noise, spoof tones."""
    g = np.random.default_rng(seed)
    wav_dir = root / "LA" / "ASVspoof2019_LA_eval" / "wav"
    proto = root / "LA" / "ASVspoof2019_LA_cm_protocols"
    wav_dir.mkdir(parents=True)
    proto.mkdir(parents=True)
    lines = []
    for i, n in enumerate(lengths):
        label = i % 2
        wav = 0.2 * g.standard_normal(n)
        if label:
            wav = 0.3 * np.sin(2 * np.pi * (500 + 40 * i) * np.arange(n)
                               / 16000) + 0.01 * wav
        write_wav(str(wav_dir / f"LA_E_{i:07d}.wav"), wav)
        lines.append(f"LA_0001 LA_E_{i:07d} - {'A07' if label else '-'} "
                     f"{'spoof' if label else 'bonafide'}")
    (proto / "ASVspoof2019.LA.cm.eval.trl.txt").write_text(
        "\n".join(lines) + "\n")


def test_slice_end_to_end_score_file_matches_jax(tmp_path):
    """Waveforms -> LFCC -> ECAPA -> OC-Softmax -> score file, both
    packages from the same weights and center. Utterances longer than the
    buffer are cropped with the same seeded draws; shorter ones are
    repeat-padded. Scores agree within 1e-4 (f32, the fused serving graph
    against the JAX model's unfused one) and the EERs are equal."""
    feat_len, bs = 60, 4
    max_samples = (feat_len - 1) * 160
    _corpus(tmp_path, [max_samples + 3000, 5000, max_samples, 2000,
                       max_samples + 900, 7000])
    model = JECAPA(C=64, model_scale=8, n_out=2, n_feat=60, enc_dim=ENC)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((2, feat_len, 60)), False)
    variables = jax.tree.map(
        lambda v: v + 0.05 * jnp.asarray(
            np.random.default_rng(1).standard_normal(v.shape), v.dtype),
        variables)
    center = np.random.default_rng(2).uniform(-2, 2, (1, ENC)).astype(
        np.float32)
    jmod, port_oc = _oc_pair(center, r_real=0.9, r_fake=0.2, alpha=20.0)

    want_path = j_score_raw(
        model, variables, JRawDataset("LA", str(tmp_path), "eval"),
        str(tmp_path / "jax_scores.txt"), labeled=True,
        frontend=JFrontend(feat_len=feat_len, padding="repeat",
                           use_pallas=False),
        loss_module=jmod, loss_vars={"params": {"center": center}},
        add_loss="ocsoftmax", batch_size=bs)
    got_path = score_raw_to_file(
        from_flax_variables(jax.tree.map(np.asarray, variables)),
        RawAudioDataset("LA", str(tmp_path), "eval"),
        str(tmp_path / "port_scores.txt"), labeled=True,
        frontend=OnDeviceFrontend(feat_len=feat_len, padding="repeat",
                                  device="cpu"),
        loss_module=port_oc, add_loss="ocsoftmax", batch_size=bs,
        dtype=torch.float32, device="cpu")

    want = [line.split() for line in open(want_path)]
    got = [line.split() for line in open(got_path)]
    assert len(got) == len(want) == 6
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got],
                               [float(r[1]) for r in want], atol=1e-4)
    assert eer_from_score_file(got_path) == j_eer(want_path)
    assert os.path.getsize(got_path) > 0


# ---------------------------------------------------------------------------
# The feature-file scorer: the 8-task router and the generate_score CLI.

import dataclasses  # noqa: E402
import json  # noqa: E402

import asvspoof2021_air_tpu.cli.generate_score as j_cli  # noqa: E402
import asvspoof2021_air_tpu.scoring as jscoring  # noqa: E402
import asvspoof2021_air_tpu_torch.scoring as pscoring  # noqa: E402
from asvspoof2021_air_tpu.interop.torch_port import port_ecapa  # noqa: E402
from asvspoof2021_air_tpu.models import registry as j_registry  # noqa: E402
from asvspoof2021_air_tpu.train.checkpoint import (  # noqa: E402
    save_checkpoint as j_save_checkpoint)
from asvspoof2021_air_tpu.train.loop import TrainConfig as JConfig  # noqa
from asvspoof2021_air_tpu.train.loop import (  # noqa: E402
    setup_training as j_setup_training)
from asvspoof2021_air_tpu_torch.cli import generate_score as p_cli  # noqa
from asvspoof2021_air_tpu_torch.interop.flax_weights import (  # noqa: E402
    random_flax_variables)
from asvspoof2021_air_tpu_torch.train.checkpoint import (  # noqa: E402
    save_checkpoint)
from asvspoof2021_air_tpu_torch.train.loop import (  # noqa: E402
    TrainConfig, setup_training)

C, FEAT_LEN, BS = 64, 50, 4
LA_CH, DEV = "amr[br=10k2,nodtx]", "iPadirRecording-16000.ir"
_JAX_SCORERS = {}


def shared_jax_make_score_fn(model, variables, loss_module=None,
                             loss_vars=None, add_loss=None):
    """The JAX ``make_score_fn`` with one jit per (model, loss, rule) for
    the whole file, the weights passed as arguments (the same function;
    one compile instead of one per task)."""
    key = (model, loss_module, add_loss)
    if key not in _JAX_SCORERS:
        def fn(v, lv, feats):
            emb, logits = model.apply(v, feats, False)
            return jscoring.score_rule(add_loss, emb, logits, loss_module, lv)
        _JAX_SCORERS[key] = jax.jit(fn)
    jitted = _JAX_SCORERS[key]
    return lambda feats: jitted(variables, loss_vars, feats)


@pytest.fixture
def small_jax(monkeypatch):
    """The JAX scorer shares one jit, and the JAX registry builds ECAPA at
    C=64 (the JAX package's is always C=512)."""
    monkeypatch.setattr(jscoring, "make_score_fn", shared_jax_make_score_fn)
    monkeypatch.setitem(
        j_registry.MODEL_REGISTRY, "ecapa",
        lambda enc_dim=256, nclasses=2, feat_dim=60, **kw: JECAPA(
            C=C, model_scale=8, n_out=nclasses, n_feat=feat_dim,
            enc_dim=enc_dim))


def _save_feat(path, t: int, seed: int, as_pt: bool = False) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    x = np.random.default_rng(seed).standard_normal((1, t, 60)).astype(
        np.float32)
    if as_pt:
        torch.save(torch.from_numpy(x), path + ".pt")
    else:
        np.save(path + ".npy", x)


def feature_trees(root) -> dict:
    """Feature caches for all 8 tasks, each task's dataset 5-9 items
    (a partial last batch of 4), T of 20 to 64 frames (repeat-padded and
    cropped to 50)."""
    k = 0
    for part, prefix in (("dev", "D"), ("eval", "E")):
        for i in range(6):
            label = "bonafide" if i % 3 == 0 else "spoof"
            tag = "-" if label == "bonafide" else f"A0{1 + i % 6}"
            _save_feat(str(root / "ori" / part / "LFCC" /
                           f"{i:06d}_LA_{prefix}_{1000 + i}_{tag}_{label}"),
                       20 + 9 * i, k, as_pt=i == 4)
            k += 1
    for tree, suffix in (("la", f"_{LA_CH}"), ("lapa", f"_{LA_CH}_{DEV}"),
                         ("df", "_mp3[16k]"), ("dfpa", f"_aac[8k]_{DEV}")):
        for i in range(3):
            label = "bonafide" if i == 0 else "spoof"
            _save_feat(str(root / tree / "dev" / "LFCC" /
                           f"{i:06d}_LA_D_{2000 + i}_{'-' if i == 0 else 'A02'}"
                           f"_{label}{suffix}"), 45 + 5 * i, k)
            k += 1
    for name in ("la_eval", "df_eval"):
        for i in range(5):
            _save_feat(str(root / name / "LFCC" / f"{i:06d}_LA_E_{3000 + i}"),
                       30 + 6 * i, k)
            k += 1
    return {"ori_features": str(root / "ori"), "la_eval":
            str(root / "la_eval"), "df_eval": str(root / "df_eval")}


AUG_TREE = {"19laaugdev": "la", "19lapaaugdev": "lapa", "19dfaugdev": "df",
            "19dfpaaugdev": "dfpa"}


def _weights(seed: int = 0):
    variables = random_flax_variables(seed, C=C, model_scale=8, enc_dim=ENC)
    center = np.random.default_rng(seed + 1).uniform(-1, 1, (1, ENC)).astype(
        np.float32)
    return variables, center


def assert_same_score_files(got_path, want_path, n: int):
    got = [line.split() for line in open(got_path)]
    want = [line.split() for line in open(want_path)]
    assert len(got) == len(want) == n
    assert {len(r) for r in got} == {len(r) for r in want}
    assert [(r[0], r[2:]) for r in got] == [(r[0], r[2:]) for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got],
                               [float(r[1]) for r in want], atol=1e-4)


@pytest.mark.parametrize("task", jscoring.TASKS)
def test_task_route_score_file_matches_jax(tmp_path, small_jax, task):
    """Each of the 8 tasks: the port's score file (plain versions on the
    CPU, f32) against the JAX ``test_on_asvspoof2021`` with the same
    weights: the same fnames and keys in the same order, the same column
    count, scores within 1e-4."""
    paths = feature_trees(tmp_path)
    paths["aug_features"] = str(tmp_path / AUG_TREE.get(task, "la"))
    variables, center = _weights()
    jmod, port_oc = _oc_pair(center, r_real=0.9, r_fake=0.2, alpha=20.0)
    model = JECAPA(C=C, model_scale=8, n_out=2, n_feat=60, enc_dim=ENC)
    want = jscoring.test_on_asvspoof2021(
        task, model, variables, paths, str(tmp_path / "jax"), "sys",
        add_loss="ocsoftmax", loss_module=jmod,
        loss_vars={"params": {"center": center}}, batch_size=BS,
        feat_len=FEAT_LEN)
    got = pscoring.test_on_asvspoof2021(
        task, from_flax_variables(variables), paths, str(tmp_path / "port"),
        "sys", add_loss="ocsoftmax", loss_module=port_oc, batch_size=BS,
        feat_len=FEAT_LEN, device="cpu")
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(
        want, tmp_path / "jax")
    n = len(pscoring.build_task_dataset(task, paths))
    assert n == (9 if "aug" in task else 6 if "19" in task else 5)
    assert_same_score_files(got, want, n)


def port_run_folder(root, variables, center) -> str:
    """A port training run folder at C=64: args.json and best.pt."""
    cfg = TrainConfig(out_fold=str(root), model="ecapa", add_loss="ang_iso",
                      on_the_fly=True, C=C, enc_dim=ENC, feat_len=FEAT_LEN,
                      r_real=0.9, r_fake=0.2, alpha=20.0)
    state = setup_training(cfg, 1, device="cpu")[2]
    state.model.load_state_dict(from_flax_variables(variables))
    with torch.no_grad():
        state.loss_module.center.copy_(torch.from_numpy(center))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    save_checkpoint(os.path.join(root, "best.pt"), state)
    return str(root)


def jax_run_folder(root, sd) -> str:
    """The JAX run folder of the same weights: the port's state_dict mapped
    with ``port_ecapa`` into a JAX TrainState, saved by the JAX
    ``save_checkpoint``."""
    cfg = JConfig(out_fold=str(root), model="ecapa", add_loss="ocsoftmax",
                  enc_dim=ENC, feat_len=FEAT_LEN)
    state = j_setup_training(cfg, steps_per_epoch=1)[2]
    jv = port_ecapa({k: v.numpy() for k, v in sd["model"].items()})
    state = state.replace(
        params=jv["params"], batch_stats=jv["batch_stats"],
        loss_params={"center": sd["loss_module"]["center"].numpy()})
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    j_save_checkpoint(os.path.join(str(root), "best"), state)
    return str(root)


@pytest.mark.parametrize("task", ["19dev", "LA"])
def test_generate_score_cli_matches_jax_cli(tmp_path, small_jax, monkeypatch,
                                            capsys, task):
    """A port run folder, scored by the port's CLI on the CPU, against the
    JAX CLI over a JAX run folder of the same weights (atol 1e-4); the
    port's --scan_batches 2 file equals its K = 1 file exactly."""
    paths = feature_trees(tmp_path / "feats")
    variables, center = _weights(3)
    port_run_folder(tmp_path / "runs" / "port", variables, center)
    sd = torch.load(tmp_path / "runs" / "port" / "best.pt",
                    weights_only=True)
    jax_run_folder(tmp_path / "runs" / "jax", sd)
    monkeypatch.chdir(tmp_path)
    common = ["--model_folder", str(tmp_path / "runs"), "-t", task,
              "--batch_size", str(BS), "--ori_features",
              paths["ori_features"], "--la_eval", paths["la_eval"]]
    j_cli.main(["-n", "jax", "-s", "jscores", *common])
    got = p_cli.main(["-n", "port", "-s", "pscores", "--device", "cpu",
                      *common])
    if task == "19dev":
        want = tmp_path / "scores" / "jax_19dev_score.txt"
        assert got == os.path.join(".", "scores", "port_19dev_score.txt")
    else:
        want = tmp_path / "jscores" / "jax_LA" / "score.txt"
        assert got == os.path.join("pscores", "port_LA", "score.txt")
    assert_same_score_files(got, want, 6 if task == "19dev" else 5)
    first = open(got).read()
    p_cli.main(["-n", "port", "-s", "pscores", "--device", "cpu",
                "--scan_batches", "2", *common])
    assert open(got).read() == first
    assert "wrote" in capsys.readouterr().out


def test_generate_score_cli_refuses_what_is_not_ported(tmp_path):
    """What the CLI refuses: an ensemble run whose checkpoint holds no
    members (ValueError; ensembles score in tests/test_torch_ensemble.py),
    and RawNet2 on the feature-file tasks (ValueError: it reads waveforms;
    ``score_raw_to_file`` scores it). Every family
    loads (tests/test_torch_res2net.py, tests/test_torch_convnet.py and
    tests/test_torch_rawnet.py score them)."""
    variables, center = _weights(4)
    run = port_run_folder(tmp_path / "port", variables, center)
    base = ["--model_folder", str(tmp_path), "-n", "port", "-t", "19dev",
            "--device", "cpu"]
    args = json.load(open(os.path.join(run, "args.json")))
    for key, value, error, match in (
            ("ensemble", 3, ValueError, "ensemble members"),
            ("model", "rawnet", ValueError, "waveforms")):
        json.dump(dict(args, **{key: value}),
                  open(os.path.join(run, "args.json"), "w"))
        with pytest.raises(error, match=match):
            p_cli.main(base)


def test_bf16_scorer_stays_within_the_bf16_bar_of_f32():
    """``make_score_fn`` defaults to f32; its bf16 option scores the same
    batch within 0.03 (the angle of the bf16 embedding bar, cos 0.9996)."""
    variables, center = _weights(5)
    _jmod, port_oc = _oc_pair(center, r_real=0.9, r_fake=0.2, alpha=20.0)
    sd = from_flax_variables(variables)
    feats = np.random.default_rng(6).standard_normal(
        (BS, FEAT_LEN, 60)).astype(np.float32)
    f32 = pscoring.make_score_fn(sd, port_oc, "ocsoftmax", device="cpu")
    bf16 = pscoring.make_score_fn(sd, port_oc, "ocsoftmax",
                                  dtype=torch.bfloat16, device="cpu")
    a, b = f32(feats), bf16(feats)
    assert a.dtype == b.dtype == torch.float32
    assert float((a - b).abs().max()) <= 0.03
