"""The installed port. A wheel built from the repo holds every file under
``asvspoof2021_air_tpu_torch/csrc/`` (the kernels' and the FLAC decoder's
sources, built at first use) and declares the nine ``asvspoof-torch-*``
console scripts beside the JAX package's nine. Installed from that wheel
(``pip install --no-deps --target``) and run from a directory outside the
repo with only the install on ``PYTHONPATH`` ahead of the environment's
own, the scripts exit 0: ``asvspoof-torch-fuse`` writes the JAX
``cli.score_fusion``'s file, ``asvspoof-torch-score --device cpu`` the
in-repo CLI's scores (1e-6), ``asvspoof-torch-train --help`` its help.
``chip_smoke.installed_files`` (the file set its phase 10 copies) names
exactly the wheel's files of the port, and the libraries build in the
per-user cache when the package directory cannot be written.

The wheel is built offline (``--no-deps --no-build-isolation --no-index``)
from a copy of the repo's packaging inputs (``pyproject.toml`` and the two
packages, without ``build/`` and ``__pycache__``), so that setuptools'
``build/`` and ``*.egg-info`` stay out of the checkout."""

import configparser
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from asvspoof2021_air_tpu import fusion as jf
from asvspoof2021_air_tpu.cli import score_fusion as j_fusion_cli
from asvspoof2021_air_tpu_torch import fusion as pf
from asvspoof2021_air_tpu_torch.cli import generate_score as p_cli
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables, random_flax_variables)
from asvspoof2021_air_tpu_torch.ops import _host_build
from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import TrainConfig, setup_training

ROOT = Path(__file__).resolve().parent.parent
PKG = "asvspoof2021_air_tpu_torch"
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check"]
# script -> the port CLI's module and function
SCRIPTS = {
    "train": "train:main", "score": "generate_score:script",
    "fuse": "score_fusion:main", "eval": "evaluate_tdcf:main",
    "preprocess": "preprocess:script", "degrade": "degrade:main",
    "export": "export:script", "visualize": "visualize:script",
    "prepare4matlab": "prepare4matlab:main"}
JAX_SCRIPTS = {
    "train": "train", "score": "generate_score", "fuse": "score_fusion",
    "eval": "evaluate_tdcf", "preprocess": "preprocess",
    "degrade": "degrade", "export": "export", "visualize": "visualize",
    "prepare4matlab": "prepare4matlab"}
C, ENC, FEAT_LEN, BS = 32, 16, 40, 4


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """(the wheel's path, the directory it is installed into)."""
    tmp = tmp_path_factory.mktemp("install")
    src = tmp / "src"
    src.mkdir()
    shutil.copy(ROOT / "pyproject.toml", src)
    for pkg in ("asvspoof2021_air_tpu", PKG):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
    subprocess.run([*PIP, "wheel", str(src), "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", "-w",
                    str(tmp / "dist")], check=True, capture_output=True)
    (whl,) = (tmp / "dist").glob("*.whl")
    target = tmp / "site"
    subprocess.run([*PIP, "install", "--no-deps", "--no-index", "-q",
                    "--target", str(target), str(whl)], check=True,
                   capture_output=True)
    return whl, target


def installed_env(target: Path) -> dict:
    """The environment's own, with only the install ahead of it on
    ``PYTHONPATH``."""
    path = [str(target), *filter(None, os.environ.get(
        "PYTHONPATH", "").split(os.pathsep))]
    return {**os.environ, "PYTHONPATH": os.pathsep.join(path),
            "PYTHONDONTWRITEBYTECODE": "1"}


def run_script(target: Path, name: str, args, cwd: Path):
    return subprocess.run([str(target / "bin" / f"asvspoof-torch-{name}"),
                           *map(str, args)], cwd=cwd,
                          env=installed_env(target), capture_output=True,
                          text=True, timeout=300)


def test_wheel_holds_every_csrc_file(wheel):
    """Every file under ``csrc/`` (``.cu``, ``.cuh``, ``host/*.cc``) is in
    the wheel, byte for byte."""
    whl, _ = wheel
    csrc = ROOT / PKG / "csrc"
    want = sorted(p for p in csrc.rglob("*") if p.is_file())
    assert {p.suffix for p in want} == {".cu", ".cuh", ".cc"}
    with zipfile.ZipFile(whl) as z:
        for p in want:
            assert z.read(str(p.relative_to(ROOT))) == p.read_bytes(), p


def test_wheel_declares_the_nine_torch_scripts(wheel):
    """``entry_points.txt``: the nine ``asvspoof-torch-*`` scripts, each on
    its CLI's ``main`` or, where ``main`` returns a value, on ``script``;
    the JAX package's nine as they were."""
    whl, _ = wheel
    with zipfile.ZipFile(whl) as z:
        (name,) = [n for n in z.namelist()
                   if n.endswith(".dist-info/entry_points.txt")]
        cfg = configparser.ConfigParser()
        cfg.read_string(z.read(name).decode())
    scripts = dict(cfg["console_scripts"])
    assert {k: v for k, v in scripts.items()
            if k.startswith("asvspoof-torch-")} == {
        f"asvspoof-torch-{k}": f"{PKG}.cli.{v}" for k, v in SCRIPTS.items()}
    assert {k: v for k, v in scripts.items()
            if not k.startswith("asvspoof-torch-")} == {
        f"asvspoof-{k}": f"asvspoof2021_air_tpu.cli.{v}:main"
        for k, v in JAX_SCRIPTS.items()}


def write_scores(path: Path, seed: int, shift: float) -> str:
    """A 3-column CM score file of 40 trials, bona fide shifted up."""
    g = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(40):
            key = "bonafide" if i % 4 == 0 else "spoof"
            s = g.standard_normal() + (shift if key == "bonafide" else 0.0)
            f.write(f"LA_E_{i:07d} {s} {key}\n")
    return str(path)


def test_installed_fuse_and_eval_scripts(wheel, tmp_path):
    """From outside the repo: ``asvspoof-torch-fuse -m avg`` and ``-m wght``
    exit 0 and write the file the JAX ``cli.score_fusion`` writes for the
    same inputs (the same rows, scores to rtol 1e-12), and
    ``asvspoof-torch-eval`` exits 0 and prints EER and min-tDCF; the
    scripts import the installed copy."""
    _, target = wheel
    inputs = [write_scores(tmp_path / f"s{i}.txt", i, 1.0 + i)
              for i in range(2)]
    where = subprocess.run(
        [sys.executable, "-c", f"import {PKG}; print({PKG}.__file__)"],
        cwd=tmp_path, env=installed_env(target), capture_output=True,
        text=True, check=True).stdout.strip()
    assert Path(where).is_relative_to(target)
    for method in ("avg", "wght"):
        out = run_script(target, "fuse", ["-i", *inputs, "-m", method, "-o",
                                          tmp_path / f"p_{method}"],
                         tmp_path)
        assert out.returncode == 0, out.stderr
        j_fusion_cli.main(["-i", *inputs, "-m", method, "-o",
                           str(tmp_path / f"j_{method}")])
        got = pf.read_score_frame(str(tmp_path / f"p_{method}" /
                                      "avg_fuse_score"))
        want = jf.read_score_frame(str(tmp_path / f"j_{method}" /
                                       "avg_fuse_score"))
        for c in ("fname", "sysid", "key"):
            assert list(got[c]) == list(want[c]), c
        np.testing.assert_allclose(got["score"], want["score"].to_numpy(),
                                   rtol=1e-12)
    out = run_script(target, "eval", [inputs[0]], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "'eer'" in out.stdout and "'min_tdcf'" in out.stdout


def run_folder(root: Path) -> None:
    """A port run folder at C=32 from seeded weights: args.json, best.pt."""
    cfg = TrainConfig(out_fold=str(root), model="ecapa", add_loss="ang_iso",
                      on_the_fly=True, C=C, enc_dim=ENC, feat_len=FEAT_LEN)
    state = setup_training(cfg, 1, device="cpu")[2]
    state.model.load_state_dict(from_flax_variables(random_flax_variables(
        4, C=C, model_scale=8, enc_dim=ENC)))
    with torch.no_grad():
        state.loss_module.center.copy_(torch.from_numpy(
            np.random.default_rng(5).uniform(-1, 1, (1, ENC))))
    root.mkdir(parents=True)
    (root / "args.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_checkpoint(str(root / "best.pt"), state)


def feature_files(root: Path, n: int = 6) -> None:
    """n seeded LFCC files of the 19dev tree, 30 to 55 frames."""
    d = root / "dev" / "LFCC"
    d.mkdir(parents=True)
    g = np.random.default_rng(8)
    for i in range(n):
        label = "bonafide" if i % 3 == 0 else "spoof"
        tag = "-" if label == "bonafide" else f"A0{1 + i % 6}"
        np.save(d / f"{i:06d}_LA_D_{1000 + i}_{tag}_{label}.npy",
                g.standard_normal((1, 30 + 5 * i, 60)).astype(np.float32))


def test_installed_score_script_matches_the_in_repo_cli(wheel, tmp_path,
                                                        monkeypatch):
    """``asvspoof-torch-score --device cpu`` from outside the repo on
    seeded LFCC files and a seeded checkpoint exits 0, and its score file
    holds the in-repo CLI's rows, the scores to 1e-6."""
    _, target = wheel
    run_folder(tmp_path / "runs" / "sys")
    feature_files(tmp_path / "feats")
    args = ["--model_folder", tmp_path / "runs", "-n", "sys", "-t", "19dev",
            "--ori_features", tmp_path / "feats", "--batch_size", BS,
            "--device", "cpu"]
    for d in ("repo", "installed"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "repo")
    p_cli.main(list(map(str, args)))
    out = run_script(target, "score", args, tmp_path / "installed")
    assert out.returncode == 0, out.stderr
    read = lambda d: [line.split() for line in open(
        tmp_path / d / "scores" / "sys_19dev_score.txt")]
    got, want = read("installed"), read("repo")
    assert len(want) == 6
    assert [(r[0], r[2:]) for r in got] == [(r[0], r[2:]) for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got],
                               [float(r[1]) for r in want], rtol=0,
                               atol=1e-6)


def test_installed_train_script_help(wheel, tmp_path):
    """``asvspoof-torch-train --help`` exits 0 and prints the CLI's
    usage."""
    _, target = wheel
    out = run_script(target, "train", ["--help"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "--compute_dtype" in out.stdout


def test_chip_smoke_installed_files_are_the_wheels(wheel):
    """``chip_smoke.installed_files`` (what phase 10 copies) names exactly
    the wheel's files of the port."""
    whl, _ = wheel
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    with zipfile.ZipFile(whl) as z:
        in_wheel = sorted(n for n in z.namelist() if n.startswith(PKG + "/"))
    assert cs.installed_files(str(ROOT)) == in_wheel


def test_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch):
    """``build_dir``: ``<package>/build`` where the process can make a
    file there; the per-user cache (``$XDG_CACHE_HOME``, else
    ``~/.cache``) where it cannot: ``build`` taken by a file (which stops
    root too), or a directory that refuses the file (what a read-only
    package directory does to a user other than root)."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    assert _host_build.build_dir(pkg) == pkg / "build"
    assert list((pkg / "build").iterdir()) == []

    def refused(*a, **k):
        raise PermissionError(13, "Permission denied")

    with monkeypatch.context() as m:
        m.setattr(_host_build.tempfile, "TemporaryFile", refused)
        assert _host_build.build_dir(pkg) == cache / PKG
    (pkg / "build").rmdir()
    (pkg / "build").write_text("")
    assert _host_build.build_dir(pkg) == cache / PKG
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _host_build.build_dir(pkg) == tmp_path / "home" / ".cache" / PKG
    assert (pkg / "build").is_file()
