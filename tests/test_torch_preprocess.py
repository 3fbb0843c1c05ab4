"""The port's feature materialization CLI (``cli/preprocess.py``) against
the JAX package's, on the CPU: both ``main``s run over the same synthetic
ASVspoof 2019 (``--dataset 2019``), augmented (``--dataset aug
--with_device``) and ASVspoof 2021 eval (``--dataset 2021eval``) trees, for
LFCC and CQCC (and STFT and Melspec on the 2019 tree), with utterances
of two buckets' lengths; the written file names must be identical, and
every array within its bar of JAX's; the port's ``build_task_dataset``
and ``RatioMixIterator`` read the trees back; the CLI's argument checks
are JAX's.

Tolerances: LFCC within 5e-4 of JAX's (the port's LFCC bar,
tests/test_torch_lfcc.py). CQCC, STFT and Melspec: within twice JAX's
own largest distance, over the tree, to the float64 value of the
function on the same padded buffer (the port's CQCC with its constants
in float64; numpy's float64 rfft for STFT and Melspec; the reasons are
in tests/test_torch_cqcc.py and tests/test_torch_frontends.py)."""

import os

import numpy as np
import pytest
import torch

import asvspoof2021_air_tpu.cli.preprocess as j_cli
import asvspoof2021_air_tpu_torch.cli.preprocess as p_cli
from asvspoof2021_air_tpu_torch.data import protocol as proto
from asvspoof2021_air_tpu_torch.data.audio_io import write_wav
from asvspoof2021_air_tpu_torch.data.datasets import AugmentedFeatureDataset
from asvspoof2021_air_tpu_torch.data.pipeline import RatioMixIterator
from asvspoof2021_air_tpu_torch.scoring import build_task_dataset
from test_torch_cqcc import float64_cqcc
from test_torch_frontends import melspec_float64, stft_float64
from torch_threads import one_thread  # noqa: F401

N, PART, BATCH = 7, "dev", 4
LFCC_BAR = 5e-4


def _wave(g, n: int, label: int) -> np.ndarray:
    w = 0.1 * g.standard_normal(n)
    if label:
        t = np.arange(n) / 16000.0
        w = 0.3 * np.sin(2 * np.pi * g.uniform(200, 3000) * t) + 0.05 * w
    return w


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A 2019 LA dev part (WAV + protocol; tags A01-A06, which the
    augmented datasets know), its augmented copies named
    ``<fname>_<channel>_<device>.wav``, and an unlabeled 2021 eval tree;
    lengths 9000 - 23000 samples, so two 16000-sample buckets."""
    root = tmp_path_factory.mktemp("pre")
    g = np.random.default_rng(0)
    db, aug, ev = root / "db", root / "aug", root / "ev"
    wav_dir = db / "LA" / f"ASVspoof2019_LA_{PART}" / "wav"
    proto_dir = db / "LA" / "ASVspoof2019_LA_cm_protocols"
    for d in (wav_dir, proto_dir, aug / PART / "codec", ev / "wav"):
        os.makedirs(d)
    lines = []
    for i in range(N):
        label = i % 2
        n = 9000 + 2300 * i
        fname = f"LA_D_{1000000 + i}"
        write_wav(str(wav_dir / f"{fname}.wav"), _wave(g, n, label))
        tag = f"A0{1 + i % 6}" if label else "-"
        lines.append(f"LA_0001 {fname} - {tag} "
                     f"{'spoof' if label else 'bonafide'}")
        channel = proto.LA_CHANNELS[1 + i % 5]
        device = proto.DEVICES[i % 3]
        write_wav(str(aug / PART / "codec"
                      / f"{fname}_{channel}_{device}.wav"),
                  _wave(g, n - 500, label))
        write_wav(str(ev / "wav" / f"LA_E_{2000000 + i}.wav"),
                  _wave(g, n + 700, label))
    (proto_dir / f"ASVspoof2019.LA.cm.{PART}.trl.txt").write_text(
        "\n".join(lines) + "\n")
    return {"db": str(db), "aug": str(aug), "ev": str(ev), "root": root}


def route_args(trees, dataset: str):
    if dataset == "2019":
        return ["-d", trees["db"], "--part", PART]
    if dataset == "aug":
        return ["--dataset", "aug", "--aug_wav_dir", trees["aug"], "-d",
                trees["db"], "--part", PART, "--with_device"]
    return ["--dataset", "2021eval", "-d", trees["ev"], "--part", "eval"]


def run_both(trees, tmp_path, dataset: str, feature: str):
    """(out dir, sorted names, port arrays, JAX arrays) of both CLIs."""
    args = route_args(trees, dataset) + ["--feature", feature,
                                         "--batch_size", str(BATCH)]
    outs = {}
    for name, main, extra in (("port", p_cli.main, ["--device", "cpu"]),
                              ("jax", j_cli.main, [])):
        main(["-o", str(tmp_path / name)] + args + extra)
        part = "eval" if dataset == "2021eval" else PART
        d = tmp_path / name / part / feature
        names = sorted(os.listdir(d))
        outs[name] = (d, names, [np.load(d / f) for f in names])
    return outs


def float64_reference(trees, dataset: str, feature: str, names):
    """Each file's float64 value on the buffer the CLI gave it: the
    utterance zero-padded to its bucket's length."""
    items = p_cli.collect_items(p_cli.build_parser().parse_args(
        ["-o", "x"] + route_args(trees, dataset)))
    refs = []
    for fname in names:
        wav = items[int(fname[:6])][0]
        n = len(wav)
        x = np.zeros((1, -(-n // 16000) * 16000), np.float32)
        x[0, :n] = wav
        if feature == "CQCC":
            out = float64_cqcc()(torch.from_numpy(x).double(),
                                 torch.tensor([n])).numpy()
            hop = 160
        elif feature == "STFT":
            out, hop = stft_float64(x), 160
        else:
            out, hop = np.transpose(melspec_float64(x), (0, 2, 1)), 128
        refs.append(out[:, :1 + n // hop])
    return refs


@pytest.mark.parametrize("dataset,feature", [
    ("2019", "LFCC"), ("aug", "LFCC"), ("2021eval", "LFCC"),
    ("2019", "CQCC"), ("aug", "CQCC"), ("2021eval", "CQCC"),
    ("2019", "STFT"), ("2019", "Melspec")])
def test_preprocess_writes_jax_names_and_arrays(trees, tmp_path, dataset,
                                                feature):
    outs = run_both(trees, tmp_path, dataset, feature)
    (_pd, p_names, got), (_jd, j_names, want) = outs["port"], outs["jax"]
    assert p_names == j_names and len(p_names) == N
    dims = {"LFCC": 60, "CQCC": 90, "STFT": 257, "Melspec": 128}[feature]
    for name, a, b in zip(p_names, got, want):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape and a.shape[0] == 1 and \
            a.shape[2] == dims, (name, a.shape, b.shape)
    if dataset == "aug":
        assert all(len(n[:-4].split("_")) == 8 for n in p_names)
    if feature == "LFCC":
        bar = LFCC_BAR
    else:
        refs = float64_reference(trees, dataset, feature, p_names)
        bar = 2 * max(float(np.abs(b - r).max())
                      for b, r in zip(want, refs))
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    assert err <= bar, (err, bar)


def test_trees_read_back_through_the_task_router_and_iterator(trees,
                                                             tmp_path):
    """The port's LFCC trees of the three routes, read back: the 19dev,
    19lapaaugdev (original + augmented with channel and device ids) and LA
    tasks' datasets, and ``RatioMixIterator`` batches over the augmented
    one."""
    out = {}
    for dataset in ("2019", "aug", "2021eval"):
        out[dataset] = str(tmp_path / dataset)
        n = p_cli.main(["-o", out[dataset], "--device", "cpu"]
                       + route_args(trees, dataset))
        assert n == N
    paths = {"ori_features": out["2019"], "aug_features": out["aug"],
             "la_eval": os.path.join(out["2021eval"], "eval"),
             "df_eval": ""}
    dev = build_task_dataset("19dev", paths)
    assert len(dev) == N and dev[0][0].shape == (1, 1 + 9000 // 160, 60)
    mixed = build_task_dataset("19lapaaugdev", paths)
    assert isinstance(mixed, AugmentedFeatureDataset)
    assert len(mixed) == 2 * N and mixed.num_original == N
    feat, fname, _tag, label, ch = mixed[N + 1]
    assert fname == "LA_D_1000001" and label == 1 and ch.shape == (2,)
    assert build_task_dataset("LA", paths)[3][1] == "LA_E_2000003"
    batches = list(RatioMixIterator(mixed, 4, 0.5, feat_len=50,
                                    seed=3).epoch())
    assert batches and all(b["feat"].shape == (4, 50, 60)
                           and b["channel"].shape == (4, 2)
                           for b in batches)


def test_argument_checks_are_jax(tmp_path, capsys):
    """Each route's missing path fails at argparse with JAX's message."""
    for argv in (["--dataset", "2019"], ["--dataset", "aug", "-d", "db"],
                 ["--dataset", "aug", "--aug_wav_dir", "a"],
                 ["--dataset", "2015", "-d", "db"],
                 ["--dataset", "vcc2020", "--path_to_spoof", "s"],
                 ["--dataset", "2021eval"]):
        msgs = []
        for main in (p_cli.main, j_cli.main):
            with pytest.raises(SystemExit):
                main(["-o", str(tmp_path)] + argv)
            msgs.append(capsys.readouterr().err.splitlines()[-1])
        assert msgs[0] == msgs[1] and "requires" in msgs[0], msgs
