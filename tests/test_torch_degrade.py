"""The port's ``cli.degrade`` against the JAX package's, on the CPU, and the
port's augmented chain degrade -> preprocess aug -> train ``--LA_aug
--ADV_AUG`` -> ``19laaugdev`` scores with JAX blocked.

Every mode (channel random and parallel at ``--fidelity native``,
compression, device, make-irs) writes the same file names and the same
bytes as the JAX CLI for the same seed, at ``-j 1`` and ``-j 3`` (the
JAX trees at ``-j 1``): both bind the same native sources built with the
same flags, and sampling is seeded on the main process. ``--fidelity
system`` is held against JAX's where the machine's libavcodec and libopus
load. The chain runs at ``tests/test_cli.py``'s sizes (8 utterances a
part, LCNN, 2 epochs, batch 8, 56 frames); its degraded wavs must equal
the JAX chain's byte for byte, and its scores are held against the JAX
CLI's scores of the same trained weights over the JAX chain's own feature
trees, atol 1e-4 (the LCNN family's scoring bar)."""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from asvspoof2021_air_tpu.cli import degrade as jdg
from asvspoof2021_air_tpu.data import system_codecs as jsys
from asvspoof2021_air_tpu_torch.cli import degrade as dg
from asvspoof2021_air_tpu_torch.data.audio_io import read_wav, write_wav
from test_cli import _synth_corpus
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(root: str, n: int = 3, samples: int = 6000) -> str:
    """``n`` seeded 16 kHz WAVs of speech-like tones under noise."""
    os.makedirs(root, exist_ok=True)
    g = np.random.default_rng(11)
    t = np.arange(samples) / 16000.0
    for i in range(n):
        w = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) + 0.05 * (
            g.standard_normal(samples))
        write_wav(os.path.join(root, f"LA_T_{i:07d}.wav"),
                  w.astype(np.float32))
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The source corpus and the JAX CLI's tree of each mode at ``-j 1``
    (device reads the IR bank of make-irs)."""
    base = tmp_path_factory.mktemp("degrade")
    wavs = _corpus(str(base / "wav"))
    jax_trees = {}
    for mode, argv in MODES.items():
        out = str(base / f"jax_{mode}")
        jdg.main([*argv(wavs, str(base / "jax_make-irs")), "-o", out])
        jax_trees[mode] = out
    return dict(base=base, wavs=wavs, jax=jax_trees)


MODES = {
    "make-irs": lambda wavs, irs: ["make-irs", "--seed", "4"],
    "channel-random": lambda wavs, irs: [
        "channel", "-i", wavs, "--sampling", "random", "--seed", "3",
        "--fidelity", "native"],
    "channel-parallel": lambda wavs, irs: [
        "channel", "-i", wavs, "--fidelity", "native"],
    "compression": lambda wavs, irs: [
        "compression", "-i", wavs, "--sampling", "random", "--seed", "5"],
    "device": lambda wavs, irs: [
        "device", "-i", wavs, "--ir_dir", os.path.join(irs, "devices"),
        "--seed", "6"],
}


def assert_same_tree(got: str, want: str) -> int:
    """The same relative file names, each byte-equal; the file count."""
    names = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                             for d, _, fs in os.walk(r) for f in fs)
    a, b = names(got), names(want)
    assert a == b and a
    for rel in a:
        assert filecmp.cmp(os.path.join(got, rel), os.path.join(want, rel),
                           shallow=False), rel
    return len(a)


@pytest.mark.parametrize("jobs", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_degrade_tree_equals_jax(trees, mode, jobs, capsys):
    """Names and bytes as the JAX CLI's; every output finite and unlike
    its source; the port's tier printed for the channel modes. make-irs
    draws one seeded stream and ignores ``-j``."""
    base = trees["base"]
    irs = str(base / "jax_make-irs")  # the JAX bank: device reads it
    out = str(base / f"port_{mode}_{jobs}")
    dg.main([*MODES[mode](trees["wavs"], irs), "-o", out, "-j", str(jobs)])
    n = assert_same_tree(out, trees["jax"][mode])
    assert n == {"make-irs": 89, "channel-random": 3,
                 "channel-parallel": 63, "compression": 3, "device": 81}[mode]
    if mode.startswith("channel"):
        assert "fidelity native -> native (silk tier)" in (
            capsys.readouterr().out)
    if mode == "make-irs":
        return
    sources = {f[:-4]: read_wav(os.path.join(trees["wavs"], f))[0]
               for f in os.listdir(trees["wavs"])}
    for f in os.listdir(out):
        w, sr = read_wav(os.path.join(out, f))
        src = sources[f[:12]]
        assert sr == 16000 and np.isfinite(w).all() and w.size == src.size
        assert not np.array_equal(w, src), f


def test_make_irs_tree_names_the_inventories(trees):
    from asvspoof2021_air_tpu_torch.data.protocol import (
        DEVICE_IR_INVENTORY, SPACE_IR_INVENTORY)
    out = str(trees["base"] / "irs_names")
    assert dg.make_irs(out, seed=4) == 89
    assert sorted(os.listdir(os.path.join(out, "devices"))) == sorted(
        s + ".wav" for s in DEVICE_IR_INVENTORY)
    assert sorted(os.listdir(os.path.join(out, "space"))) == sorted(
        s + ".wav" for s in SPACE_IR_INVENTORY)


def test_codec_vocabulary_and_auto_rule_are_jax_s():
    for name in ("LANDLINE", "VOIP", "CELLULAR", "COMMON", "COMPRESSION",
                 "RMS_LEVELS"):
        assert getattr(dg, name) == getattr(jdg, name), name
    for name in dg.LANDLINE + dg.VOIP + dg.CELLULAR + dg.COMMON:
        assert dg._parse_kbps(name, 1.0) == jdg._parse_kbps(name, 1.0)
        assert dg._parse_loss(name) == jdg._parse_loss(name)
    assert dg.resolve_fidelity("native") == "native"
    assert dg.resolve_fidelity("auto") == jdg.resolve_fidelity("auto")
    with pytest.raises(SystemExit):
        dg.main(["channel", "-o", "x"])          # no -i


def test_system_fidelity_equals_jax(trees, capsys):
    """``--fidelity system``: the silk entries through the machine's
    libopus, byte-equal to the JAX CLI's; refused by name where the
    libraries do not load."""
    from asvspoof2021_air_tpu_torch.data import system_codecs
    if not jsys.available():
        assert not system_codecs.available()
        with pytest.raises(SystemExit):
            dg.main(["channel", "-i", trees["wavs"], "-o",
                     str(trees["base"] / "sys"), "--fidelity", "system"])
        pytest.skip("libavcodec/libopus not loadable: system tier refused")
    assert system_codecs.available()
    base = trees["base"]
    argv = ["channel", "-i", trees["wavs"], "--fidelity", "system",
            "--seed", "9"]
    jdg.main([*argv, "-o", str(base / "jax_sys")])
    dg.main([*argv, "-o", str(base / "port_sys"), "-j", "2"])
    assert "fidelity system -> system" in capsys.readouterr().out
    assert assert_same_tree(str(base / "port_sys"),
                            str(base / "jax_sys")) == 63
    assert any("silk" in f for f in os.listdir(base / "port_sys"))


CHAIN = r"""
import os, runpy, sys
for m in ('jax', 'jaxlib', 'flax', 'asvspoof2021_air_tpu'):
    sys.modules[m] = None
tmp, db, protdir = sys.argv[1:4]
import asvspoof2021_air_tpu_torch.cli.degrade as dg
import asvspoof2021_air_tpu_torch.cli.generate_score as gs
import asvspoof2021_air_tpu_torch.cli.preprocess as pp
import asvspoof2021_air_tpu_torch.cli.train as tr
import torch
torch.manual_seed(0)
torch.set_num_threads(1)
aug_wavs = os.path.join(tmp, "aug_wavs")
feats, aug_feats = os.path.join(tmp, "feats"), os.path.join(tmp, "aug_feats")
for part in ("train", "dev"):
    dg.main(["channel", "-i", os.path.join(db, "LA",
             f"ASVspoof2019_LA_{part}", "wav"), "-o",
             os.path.join(aug_wavs, part), "--sampling", "random",
             "--seed", "3", "--fidelity", "native"])
    pp.main(["-d", db, "-o", feats, "--part", part, "--device", "cpu"])
    pp.main(["--dataset", "aug", "--aug_wav_dir", aug_wavs,
             "--path_to_protocol", protdir, "-o", aug_feats, "--part", part,
             "--device", "cpu"])
tr.main(["-o", os.path.join(tmp, "runs", "run"), "-f", feats,
         "--path_to_aug_features", aug_feats, "-m", "lcnn", "--add_loss",
         "ang_iso", "--LA_aug", "true", "--ADV_AUG", "true",
         "--num_epochs", "2", "--batch_size", "8", "--feat_len", "56",
         "--ratio", "0.5", "--enc_dim", "32", "--device", "cpu"])
os.chdir(tmp)
gs.main(["--model_folder", os.path.join(tmp, "runs"), "-n", "run", "-t",
         "19laaugdev", "-l", "ocsoftmax", "--ori_features", feats,
         "--aug_features", aug_feats, "--batch_size", "8", "--device", "cpu"])
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                     'asvspoof2021_air_tpu'))
print("JAX MODULES:", bad)
"""


def test_augmented_chain_runs_with_jax_blocked_and_scores_as_jax(
        tmp_path, monkeypatch):
    """The port's chain in a process where jax, flax and the JAX package
    cannot be imported; then, here, the JAX chain's degrade and preprocess
    of the same corpus: the degraded wavs byte-equal, the channel labels
    the degraded names give, and the JAX CLI's 19laaugdev scores of the
    port's trained LCNN (``port_lcnn`` of its weights, its center) over
    the JAX feature trees within 1e-4 of the port's score file."""
    import asvspoof2021_air_tpu.cli.generate_score as jgs
    import asvspoof2021_air_tpu.cli.preprocess as jpp
    import asvspoof2021_air_tpu.train.loop as jloop
    from asvspoof2021_air_tpu.interop.torch_port import port_lcnn
    from asvspoof2021_air_tpu.train.checkpoint import (
        save_checkpoint as j_save_checkpoint)
    from asvspoof2021_air_tpu_torch.data import protocol as proto
    from asvspoof2021_air_tpu_torch.data.datasets import (
        AugmentedFeatureDataset)
    from test_torch_scoring import assert_same_score_files

    db = str(tmp_path / "db")
    protdir = _synth_corpus(db, parts=("train", "dev"), n=8)
    port = tmp_path / "port"
    port.mkdir()
    out = subprocess.run([sys.executable, "-c", CHAIN, str(port), db,
                          protdir], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX MODULES: []" in out.stdout
    assert "fidelity native -> native (silk tier)" in out.stdout
    score_file = port / "scores" / "run_19laaugdev_score.txt"
    rows = [ln.split() for ln in score_file.read_text().splitlines()]
    assert len(rows) == 16 and all(
        len(r) == 3 and r[2] in ("bonafide", "spoof")
        and np.isfinite(float(r[1])) for r in rows)

    jx = tmp_path / "jax"
    feats, aug_feats = str(jx / "feats"), str(jx / "aug_feats")
    for part in ("train", "dev"):
        jdg.channel_degrade(
            os.path.join(db, "LA", f"ASVspoof2019_LA_{part}", "wav"),
            str(jx / "aug_wavs" / part), mode="random", seed=3,
            fidelity="native")
        jpp.main(["-d", db, "-o", feats, "--part", part])
        jpp.main(["--dataset", "aug", "--aug_wav_dir", str(jx / "aug_wavs"),
                  "--path_to_protocol", protdir, "-o", aug_feats,
                  "--part", part])
    assert assert_same_tree(str(port / "aug_wavs"),
                            str(jx / "aug_wavs")) == 16
    # ADV_AUG's channel labels come from the degraded names
    ds = AugmentedFeatureDataset(str(port / "feats"),
                                 str(port / "aug_feats"), "train", "LFCC",
                                 variant="LA")
    names = os.listdir(port / "aug_wavs" / "train")
    codecs = sorted(f[len("LA_T_0000000_"):-4] for f in names)
    labels = sorted(ds.channel[ds[i][4]]
                    for i in range(ds.num_original, len(ds)))
    assert labels == codecs and set(codecs) <= set(proto.LA_CHANNELS)

    # a JAX run folder holding the port's trained weights and center
    ckpt = torch.load(port / "runs" / "run" / "best.pt", weights_only=False)
    with open(port / "runs" / "run" / "args.json") as f:
        pargs = json.load(f)
    sd = {k: v.numpy() for k, v in ckpt["model"].items()}
    jv = port_lcnn(sd, 60, pargs["feat_len"])
    center = ckpt["loss_module"]["center"].numpy()
    jrun = str(jx / "runs" / "run")
    jcfg = jloop.TrainConfig(out_fold=jrun, model="lcnn", add_loss="ang_iso",
                             enc_dim=32, feat_len=56, LA_aug=True,
                             ADV_AUG=True)
    jst = jloop.setup_training(jcfg, steps_per_epoch=1)[2]
    jst = jst.replace(params=jv["params"], batch_stats=jv["batch_stats"],
                      loss_params={"center": center})
    os.makedirs(jrun)
    with open(os.path.join(jrun, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    j_save_checkpoint(os.path.join(jrun, "best"), jst)
    monkeypatch.chdir(jx)
    jgs.main(["--model_folder", str(jx / "runs"), "-n", "run", "-t",
              "19laaugdev", "-l", "ocsoftmax", "--ori_features", feats,
              "--aug_features", aug_feats, "--batch_size", "8"])
    assert_same_score_files(score_file,
                            jx / "scores" / "run_19laaugdev_score.txt", 16)
