"""The port's embedding visualization against the JAX package's, on the
CPU: the JAX ``tests/test_visualize.py`` cases run through the port.

``visualize_dev_and_eval`` is the same host code (numpy, sklearn's t-SNE
and PCA, matplotlib Agg) in both packages: the points of every panel are
read from the figure as it is saved and must equal JAX's bit for bit, for
the 2x2 figure and the dev-only 2x1 fallback. ``cli.visualize`` embeds a
trained port run's dev features on the CPU: its embeddings are held
against the JAX CLI's extraction from the same weights (``port_lcnn``)
within 1e-4 of their largest magnitude, and it writes the PDF.
``train(visualize=True)`` writes the figure every third epoch, dev and
eval panels with ``test_on_eval``. ``compute_eer_and_tdcf(plot=True)``
writes the two figures JAX's writes, with the same curves."""

import dataclasses
import json
import os

import matplotlib.figure
import numpy as np
import pytest
import torch

import asvspoof2021_air_tpu.metrics.evaluate as je
from asvspoof2021_air_tpu.visualize import visualize_dev_and_eval as j_vis
import asvspoof2021_air_tpu_torch.metrics.evaluate as pe
from asvspoof2021_air_tpu_torch.cli import visualize as pviz
from asvspoof2021_air_tpu_torch.visualize import visualize_dev_and_eval
from torch_threads import one_thread  # noqa: F401

ENC, T = 16, 20


@pytest.fixture
def saved_figures(monkeypatch):
    """Every figure saved while the fixture is open, as the points and
    lines of its axes: [[(scatter offsets..., line xy...) per axes]]."""
    figures = []
    save = matplotlib.figure.Figure.savefig

    def record(fig, *args, **kwargs):
        figures.append([
            [np.asarray(c.get_offsets()) for c in ax.collections]
            + [np.asarray(ln.get_xydata()) for ln in ax.lines]
            for ax in fig.axes])
        return save(fig, *args, **kwargs)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", record)
    return figures


def assert_same_figures(got, want):
    assert len(got) == len(want) and got
    for fa, fb in zip(got, want):
        assert len(fa) == len(fb)
        for axa, axb in zip(fa, fb):
            assert len(axa) == len(axb)
            for a, b in zip(axa, axb):
                np.testing.assert_array_equal(a, b)


def _embeddings(seed: int, n_dev: int, n_eval: int):
    g = np.random.default_rng(seed)
    dev = g.standard_normal((n_dev, ENC)).astype(np.float32)
    ev = g.standard_normal((n_eval, ENC)).astype(np.float32)
    center = g.standard_normal((1, ENC)).astype(np.float32)
    return dev, np.arange(n_dev) % 2, ev, np.arange(n_eval) % 2, center


def test_visualize_writes_pdf(tmp_path, saved_figures):
    dev, dev_l, ev, ev_l, center = _embeddings(0, 120, 100)
    out = visualize_dev_and_eval(dev, dev_l, ev, ev_l, center,
                                 out_fold=str(tmp_path / "p"), epoch=1,
                                 sample=100)
    assert os.path.basename(out) == "embedding_vis_epoch1.pdf"
    assert os.path.getsize(out) > 1000
    j_vis(dev, dev_l, ev, ev_l, center, out_fold=str(tmp_path / "j"),
          epoch=1, sample=100)
    got, want = saved_figures[:1], saved_figures[1:]
    assert len(got[0]) == 4               # t-SNE and PCA, dev and eval
    assert_same_figures(got, want)


def test_visualize_dev_only_fallback(tmp_path, saved_figures):
    """No eval embeddings: a 2x1 dev-only figure, not the dev points
    under an Eval title."""
    dev, dev_l, _, _, center = _embeddings(1, 80, 1)
    out = visualize_dev_and_eval(dev, dev_l, None, None, center,
                                 out_fold=str(tmp_path / "p"), epoch=2,
                                 sample=80)
    assert os.path.getsize(out) > 1000
    j_vis(dev, dev_l, None, None, center, out_fold=str(tmp_path / "j"),
          epoch=2, sample=80)
    assert len(saved_figures[0]) == 2
    assert_same_figures(saved_figures[:1], saved_figures[1:])


def _write_dev(root, n: int = 12, seed: int = 0):
    """``n`` LFCC-shaped dev feature files; spoof items shifted by 2."""
    g = np.random.default_rng(seed)
    for part in ("dev", "train"):
        d = os.path.join(root, part, "LFCC")
        os.makedirs(d)
        for i in range(n):
            label, tag = ("spoof", "A01") if i % 2 else ("bonafide", "-")
            arr = g.standard_normal((1, T, 60)).astype(np.float32) + 2.0 * (
                i % 2)
            np.save(os.path.join(d, f"{i:06d}_LA_D_{i:04d}_{tag}_{label}"
                                    ".npy"), arr)


def test_visualize_cli_and_training_with_visualize(tmp_path):
    """``train(visualize=True)`` of a port LCNN + ang_iso run from feature
    files writes the epoch-1 figure (dev and eval panels, the eval set
    scored by ``test_on_eval``) and not the epoch-2 one; ``cli.visualize``
    of that run writes its PDF, from embeddings within 1e-4 of the JAX
    CLI's extraction of the same weights (a JAX run folder of
    ``port_lcnn`` of them), and the center is the run's."""
    from asvspoof2021_air_tpu.cli import visualize as jviz
    from asvspoof2021_air_tpu.cli.generate_score import load_system
    from asvspoof2021_air_tpu.data.datasets import (
        ASVspoof2019FeatureDataset as JDataset)
    from asvspoof2021_air_tpu.interop.torch_port import port_lcnn
    from asvspoof2021_air_tpu.train import loop as jloop
    from asvspoof2021_air_tpu.train.checkpoint import (
        save_checkpoint as j_save_checkpoint)
    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset)
    from asvspoof2021_air_tpu_torch.train.loop import TrainConfig, train

    feats = str(tmp_path / "feats")
    _write_dev(feats)
    run = tmp_path / "runs" / "run"
    cfg = TrainConfig(out_fold=str(run), path_to_features=feats,
                      model="lcnn", add_loss="ang_iso", batch_size=4,
                      feat_len=T, enc_dim=ENC, num_epochs=2,
                      visualize=True, test_on_eval=True)
    eval_set = ASVspoof2019FeatureDataset("LA", feats, "dev", "LFCC")
    summary = train(cfg, device="cpu", eval_set=eval_set)
    assert summary["epochs"] == 2
    pdfs = sorted(f for f in os.listdir(run) if f.endswith(".pdf"))
    assert pdfs == ["embedding_vis_epoch1.pdf"]

    path = pviz.main(["--model_folder", str(tmp_path / "runs"), "-n", "run",
                      "-f", feats, "--batch_size", "4", "--sample", "12",
                      "-o", str(tmp_path / "viz"), "--device", "cpu"])
    assert os.path.getsize(path) > 1000

    # the same weights in a JAX run folder, embedded by the JAX CLI's code
    ckpt = torch.load(run / "best.pt", weights_only=False)
    jv = port_lcnn({k: v.numpy() for k, v in ckpt["model"].items()}, 60, T)
    jrun = str(tmp_path / "jruns" / "run")
    jcfg = jloop.TrainConfig(out_fold=jrun, model="lcnn", add_loss="ang_iso",
                             batch_size=4, feat_len=T, enc_dim=ENC)
    jst = jloop.setup_training(jcfg, steps_per_epoch=1)[2]
    center = ckpt["loss_module"]["center"].numpy()
    jst = jst.replace(params=jv["params"], batch_stats=jv["batch_stats"],
                      loss_params={"center": center})
    os.makedirs(jrun)
    with open(os.path.join(jrun, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    j_save_checkpoint(os.path.join(jrun, "best"), jst)
    model, variables, _lm, loss_vars, _cfg = load_system(jrun, "best")
    want, want_l = jviz._extract(jviz._make_embed(model, variables),
                                 JDataset("LA", feats, "dev", "LFCC"), 4, T,
                                 "repeat", 12)
    from asvspoof2021_air_tpu_torch.cli.generate_score import (
        load_system as p_load_system)
    from asvspoof2021_air_tpu_torch.scoring import build_scoring_model
    sd, loss_mod, pcfg = p_load_system(str(run), "best", "cpu")
    net = build_scoring_model(sd, "lcnn", feat_dim=60, device="cpu")
    got, got_l = pviz.extract(net, eval_set, 4, T, pcfg.padding, "cpu", 12)
    assert got.shape == want.shape == (12, ENC)
    np.testing.assert_array_equal(got_l, want_l)
    assert np.abs(got - np.asarray(want)).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(
        loss_mod.center.detach().numpy(),
        np.asarray(loss_vars["params"]["center"]))


def test_plot_writes_the_jax_histograms_and_tdcf_curve(tmp_path,
                                                       saved_figures):
    """``compute_eer_and_tdcf(plot=True)``: the ASV and CM score
    histograms (``<prefix>1.png``) and the t-DCF curve (``<prefix>2.png``),
    with the curves JAX's function draws."""
    g = np.random.default_rng(3)
    cm = tmp_path / "cm.txt"
    with open(cm, "w") as f:
        for i in range(60):
            key = "bonafide" if i % 2 == 0 else "spoof"
            s = g.standard_normal() + (1.5 if key == "bonafide" else 0.0)
            f.write(f"LA_E_{i:07d} A{i % 19:02d} {key} {s:.6f}\n")
    asv = tmp_path / "asv.txt"
    with open(asv, "w") as f:
        for i, key in enumerate(["target"] * 30 + ["nontarget"] * 30
                                + ["spoof"] * 30):
            shift = {"target": 2.0, "nontarget": -1.0, "spoof": 0.5}[key]
            f.write(f"LA_{i:04d} {key} {g.standard_normal() + shift:.6f}\n")
    prefix = str(tmp_path / "port_")
    got = pe.compute_eer_and_tdcf(str(cm), asv_score_file=str(asv),
                                  plot=True, plot_path_prefix=prefix)
    want = je.compute_eer_and_tdcf(str(cm), asv_score_file=str(asv),
                                   plot=True,
                                   plot_path_prefix=str(tmp_path / "jax_"))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for k in (1, 2):
        assert os.path.getsize(f"{prefix}{k}.png") > 1000
    assert len(saved_figures) == 4
    assert_same_figures(saved_figures[:2], saved_figures[2:])
