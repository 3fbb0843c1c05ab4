"""The port's score evaluation and fusion against the JAX package's, on
synthetic CM and ASV score files: score-file reading (2, 3 and 4
columns), EER and min-tDCF, the t-DCF curve, average and entropy-weighted
fusion (the rows and order of the JAX pandas frames), and the
evaluate_tdcf, prepare4matlab and score_fusion CLIs (the same printed
values and written files). Every number to rtol 1e-12."""

import ast
import os

import numpy as np
import pytest

from asvspoof2021_air_tpu import fusion as jf
from asvspoof2021_air_tpu.cli import evaluate_tdcf as j_eval_cli
from asvspoof2021_air_tpu.cli import prepare4matlab as j_matlab_cli
from asvspoof2021_air_tpu.cli import score_fusion as j_fusion_cli
from asvspoof2021_air_tpu.metrics import evaluate as je
from asvspoof2021_air_tpu.metrics import tdcf as jt
from asvspoof2021_air_tpu_torch import fusion as pf
from asvspoof2021_air_tpu_torch.cli import evaluate_tdcf as p_eval_cli
from asvspoof2021_air_tpu_torch.cli import prepare4matlab as p_matlab_cli
from asvspoof2021_air_tpu_torch.cli import score_fusion as p_fusion_cli
from asvspoof2021_air_tpu_torch.metrics import eer as peer
from asvspoof2021_air_tpu_torch.metrics import evaluate as pe
from asvspoof2021_air_tpu_torch.metrics import tdcf as pt

RTOL = 1e-12
N = 60


def names(seed: int):
    return [f"LA_E_{i:07d}" for i in np.random.default_rng(seed).permutation(
        N)]


def keys(fnames):
    return ["bonafide" if int(f[-3:]) % 4 == 0 else "spoof" for f in fnames]


def write_cm(path, seed: int, layout: int = 3, shift: float = 1.5):
    """A CM score file: bona fide scores shifted up by ``shift``."""
    g = np.random.default_rng(seed)
    fnames = names(0)
    with open(path, "w") as f:
        for fname, key in zip(fnames, keys(fnames)):
            s = g.standard_normal() + (shift if key == "bonafide" else 0.0)
            if layout == 2:
                f.write(f"{fname} {s}\n")
            elif layout == 3:
                f.write(f"{fname} {s} {key}\n")
            else:
                f.write(f"{fname} A{int(fname[-2:]) % 3} {key} {s}\n")
    return str(path)


def write_asv(path, seed: int = 7):
    g = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(200):
            kind = ("target", "nontarget", "spoof")[i % 3]
            s = g.standard_normal() + {"target": 3.0, "nontarget": -2.0,
                                       "spoof": 1.0}[kind]
            f.write(f"LA_{i:04d} {kind} {s}\n")
    return str(path)


@pytest.mark.parametrize("layout", [2, 3, 4])
def test_read_score_file_equals_jax(tmp_path, layout):
    path = write_cm(tmp_path / "s.txt", 1, layout)
    got, want = pe.read_score_file(path), je.read_score_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None
        else:
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("layout", [3, 4])
def test_eer_from_score_file_equals_jax(tmp_path, layout):
    path = write_cm(tmp_path / "s.txt", 2, layout, shift=0.8)
    want = je.eer_from_score_file(path)
    assert 0 < want < 0.5
    np.testing.assert_allclose(pe.eer_from_score_file(path), want, rtol=RTOL)
    # metrics/eer re-exports the evaluate function under the same name
    assert peer.eer_from_score_file is pe.eer_from_score_file
    with pytest.raises(ValueError, match="key"):
        pe.eer_from_score_file(write_cm(tmp_path / "u.txt", 2, 2))


@pytest.mark.parametrize("shift", [1.5, -1.5])
def test_eer_and_min_tdcf_equal_jax(tmp_path, shift):
    """Both score polarities: min-tDCF is taken on the better one."""
    cm = write_cm(tmp_path / "cm.txt", 3, 3, shift)
    asv = write_asv(tmp_path / "asv.txt")
    eer, tdcf = pe.compute_eer_and_tdcf(cm, asv_score_file=asv)
    want_eer, want_tdcf = je.compute_eer_and_tdcf(cm, asv_score_file=asv)
    assert tdcf is not None and np.isfinite(tdcf)
    np.testing.assert_allclose([eer, tdcf], [want_eer, want_tdcf], rtol=RTOL)
    assert pe.compute_eer_and_tdcf(cm)[1] is None
    # plot=True writes the JAX function's two figures and the same numbers
    prefix = str(tmp_path / f"plot{shift}_")
    assert pe.compute_eer_and_tdcf(cm, asv_score_file=asv, plot=True,
                                   plot_path_prefix=prefix) == (eer, tdcf)
    for k in (1, 2):
        assert os.path.getsize(f"{prefix}{k}.png") > 1000


def test_tdcf_curve_and_asv_error_rates_equal_jax():
    g = np.random.default_rng(5)
    tar, non, spf = (g.standard_normal(40) + 2, g.standard_normal(50) - 1,
                     g.standard_normal(30))
    got = pt.obtain_asv_error_rates(tar, non, spf, 0.3)
    want = jt.obtain_asv_error_rates(tar, non, spf, 0.3)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    bona, spoof = g.standard_normal(25) + 1, g.standard_normal(35)
    curve, thr = pt.compute_tDCF(bona, spoof, *got)
    want_curve, want_thr = jt.compute_tDCF(bona, spoof, *want)
    np.testing.assert_allclose(curve, want_curve, rtol=RTOL)
    np.testing.assert_allclose(thr, want_thr, rtol=RTOL)
    assert pt.ASVSPOOF2019_COST_MODEL == jt.ASVSPOOF2019_COST_MODEL
    with pytest.raises(ValueError, match="binary"):
        pt.compute_tDCF([0.0, 1.0], [0.0, 1.0], *got)


def assert_frames_equal(got, want):
    """A port frame against a JAX pandas frame: the same rows in the same
    order, scores to rtol 1e-12."""
    for c in ("fname", "sysid", "key"):
        assert list(got[c]) == list(want[c]), c
    np.testing.assert_allclose(got["score"], want["score"].to_numpy(),
                               rtol=RTOL)


@pytest.mark.parametrize("layouts", [(3, 3, 3), (4, 4), (2, 2), (3, 2)])
def test_fusion_equals_jax(tmp_path, layouts):
    paths = [write_cm(tmp_path / f"s{i}.txt", 10 + i, layout,
                      shift=0.5 + 0.6 * i)
             for i, layout in enumerate(layouts)]
    for i, path in enumerate(paths):
        assert_frames_equal(pf.read_score_frame(path),
                            jf.read_score_frame(path))
    got = pf.avg_fuse(paths, str(tmp_path / "p_avg"))
    assert_frames_equal(got, jf.avg_fuse(paths, str(tmp_path / "j_avg")))
    assert_frames_equal(pf.read_score_frame(str(tmp_path / "p_avg")),
                        jf.read_score_frame(str(tmp_path / "j_avg")))
    if all(layout != 2 for layout in layouts):
        got = pf.weighted_fuse(paths, output=str(tmp_path / "p_w"))
        want = jf.weighted_fuse(paths, output=str(tmp_path / "j_w"))
        assert_frames_equal(got, want)
        assert_frames_equal(pf.read_score_frame(str(tmp_path / "p_w")),
                            jf.read_score_frame(str(tmp_path / "j_w")))
        np.testing.assert_allclose(pf.fused_eer(got), jf.fused_eer(want),
                                   rtol=RTOL)


@pytest.mark.parametrize("eers", [[0.1, 0.2, 0.05], [0.3, 0.3],
                                  [0.02, 0.5, 0.5, 0.11]])
def test_entropy_weights_equal_jax(eers):
    np.testing.assert_allclose(pf.entropy_weights(eers),
                               jf.entropy_weights(eers), rtol=RTOL)


def last_dict(out: str) -> dict:
    return ast.literal_eval(out.strip().splitlines()[-1])


def test_cli_evaluate_tdcf_prepare4matlab_and_fusion_equal_jax(tmp_path,
                                                               capsys):
    cm = write_cm(tmp_path / "cm.txt", 20, 3, shift=1.0)
    asv = write_asv(tmp_path / "asv.txt")
    p_eval_cli.main([cm, "--asv_score_file", asv])
    got = last_dict(capsys.readouterr().out)
    j_eval_cli.main([cm, "--asv_score_file", asv])
    want = last_dict(capsys.readouterr().out)
    assert sorted(got) == ["eer", "min_tdcf"]
    np.testing.assert_allclose([got["eer"], got["min_tdcf"]],
                               [want["eer"], want["min_tdcf"]], rtol=RTOL)

    tar, non = p_matlab_cli.convert2txt(cm)
    want_text = [open(p).read() for p in (tar, non)]
    j_matlab_cli.main([cm])
    assert [open(p).read() for p in (tar, non)] == want_text
    assert len(want_text[0].split()) == sum(k == "bonafide"
                                            for k in keys(names(0)))

    inputs = [cm, write_cm(tmp_path / "cm2.txt", 21, 3, shift=0.3)]
    for method in ("avg", "wght"):
        capsys.readouterr()
        p_fusion_cli.main(["-i", *inputs, "-m", method, "-o",
                           str(tmp_path / "p")])
        got = float(capsys.readouterr().out.strip().splitlines()[-1])
        j_fusion_cli.main(["-i", *inputs, "-m", method, "-o",
                           str(tmp_path / "j")])
        want = float(capsys.readouterr().out.strip().splitlines()[-1])
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert_frames_equal(
            pf.read_score_frame(str(tmp_path / "p" / "avg_fuse_score")),
            jf.read_score_frame(str(tmp_path / "j" / "avg_fuse_score")))


@pytest.mark.parametrize("layout", [2, 3])
def test_write_fused_score_file_equals_jax(tmp_path, layout):
    """The ensemble members' fusion of ``cli.generate_score``: average and
    weighted, in the members' own layout; a trial order that differs is
    refused."""
    from asvspoof2021_air_tpu.cli.generate_score import (
        write_fused_score_file as j_fuse)
    from asvspoof2021_air_tpu_torch.cli.generate_score import (
        write_fused_score_file as p_fuse)

    members = [write_cm(tmp_path / f"m{i}.txt", 30 + i, layout)
               for i in range(3)]
    for weights in (None, [0.5, 0.3, 0.2]):
        got = pe.read_score_file(p_fuse(members, str(tmp_path / "p.txt"),
                                        weights))
        want = je.read_score_file(j_fuse(members, str(tmp_path / "j.txt"),
                                         weights))
        assert np.array_equal(got["fname"], want["fname"])
        assert (got["key"] is None) == (layout == 2)
        if layout == 3:
            assert np.array_equal(got["key"], want["key"])
        np.testing.assert_allclose(got["score"], want["score"], rtol=RTOL)
    with open(members[1]) as f:
        rows = f.readlines()
    with open(members[1], "w") as f:
        f.writelines(rows[::-1])
    with pytest.raises(ValueError, match="order"):
        p_fuse(members, str(tmp_path / "p.txt"))
