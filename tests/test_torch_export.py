"""The port's serving export (``cli/export.py``, ``torch.export``) against
the JAX package's (``cli/export.py``, ``jax.export``), on the CPU.

The JAX test's six cases (``tests/test_export.py``), each on a run folder
that ``tests/test_export._make_run`` writes and
``tools/jax_checkpoint_to_torch.py`` converts; then one ECAPA case, whose
artifact keeps kernels B1, B2 and B3 as the custom ops ``asv_torch::*``.
Tolerances: the loaded ``.pt2`` against the live port scorer 1e-5 (the
export's own ``--check`` bar, JAX's); against the JAX artifact's
``back.call`` on the same input 1e-4 (the bar ``test_torch_scoring.py``
holds the port's scorer to against JAX's).
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from jax import export as jax_export

from asvspoof2021_air_tpu.cli.export import export_system as j_export
from asvspoof2021_air_tpu_torch.cli import export as p_export
from asvspoof2021_air_tpu_torch.cli.generate_score import load_system
from asvspoof2021_air_tpu_torch.ops import custom_ops
from asvspoof2021_air_tpu_torch.scoring import make_score_fn

from test_export import B, _make_run

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_torch", ROOT / "tools" / "jax_checkpoint_to_torch.py")
converter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(converter)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch runs: beside the suite's
    other workers, torch's default of a thread per core oversubscribes the
    CPU (a 3 s training run took 359 s in a six-worker run of the suite,
    tests/test_torch_int8.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RAWNET_TINY = {
    "nb_samp": 6400, "first_conv": 129, "in_channels": 1,
    "filts": [4, [4, 4], [4, 8], [8, 8]], "blocks": [2, 4],
    "nb_fc_node": 16, "gru_node": 16, "nb_gru_layer": 1, "nb_classes": 2,
}


def _runs(tmp_path, name, **cfg):
    """(JAX run folder, the port's run folder converted from it)."""
    jax_run = _make_run(tmp_path, name, **cfg)
    port_run = str(tmp_path / f"{name}_port")
    converter.convert(jax_run, port_run)
    return jax_run, port_run


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The JAX test's default run (LCNN + ang_iso), shared by the feature,
    --raw and int8 cases."""
    return _runs(tmp_path_factory.mktemp("single"), "single")


def _export_both(tmp_path, name, jax_run, port_run, **kw):
    """Both packages' artifacts of one run: (port meta, loaded port module,
    the JAX ``back``)."""
    art = str(tmp_path / f"{name}.pt2")
    meta = p_export.export_system(port_run, art, check=True, device="cpu",
                                  **kw)
    assert os.path.exists(art)
    assert json.load(open(art + ".json")) == meta
    assert meta["platforms"] == ["cpu"]
    assert meta["custom_op_namespace"] == custom_ops.NAMESPACE
    assert meta["bytes"] == os.path.getsize(art)
    jart = str(tmp_path / f"{name}.stablehlo")
    j_export(jax_run, jart, **kw)
    with open(jart, "rb") as f:
        back = jax_export.deserialize(f.read())
    return meta, torch.export.load(art).module(), back


def _scores(module, *args):
    with torch.no_grad():
        return module(*(torch.from_numpy(a) for a in args)).numpy()


def _against_jax(got, back, *args):
    want = np.asarray(back.call(*args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _live(port_run, rule):
    """The live port scorer of a run folder: each member's make_score_fn."""
    sd, loss_mod, cfg = load_system(port_run, device="cpu")
    sds = sd if cfg.ensemble > 1 else [sd]
    losses = loss_mod if cfg.ensemble > 1 else [loss_mod]
    return [make_score_fn(s, lm, rule, model=cfg.model,
                          feat_dim=cfg.feat_dim, device="cpu")
            for s, lm in zip(sds, losses)]


def test_export_feature_scoring_roundtrip(tmp_path, single):
    jax_run, port_run = single
    meta, back, jback = _export_both(tmp_path, "single", jax_run, port_run,
                                     batch_size=B)
    assert meta["mode"] == "features" and meta["ensemble"] == 1
    assert meta["signature"] == {"feat": [B, 32, 60, "float32"]}
    feats = np.random.default_rng(1).standard_normal(
        (B, 32, 60)).astype(np.float32)
    scores = _scores(back, feats)
    assert scores.shape == (B,) and np.isfinite(scores).all()
    # ang_iso scoring rule: negated cosine, bounded
    assert np.abs(scores).max() <= 1.0 + 1e-5
    live = _live(port_run, "ang_iso")[0](feats).numpy()
    np.testing.assert_allclose(scores, live, rtol=1e-5, atol=1e-5)
    _against_jax(scores, jback, feats)


def test_export_ensemble_fused(tmp_path):
    jax_run, port_run = _runs(tmp_path, "ens", ensemble=2)
    meta, back, jback = _export_both(tmp_path, "ens", jax_run, port_run,
                                     batch_size=B)
    assert meta["ensemble"] == 2
    feats = np.random.default_rng(2).standard_normal(
        (B, 32, 60)).astype(np.float32)
    fused = _scores(back, feats)
    members = [fn(feats).numpy() for fn in _live(port_run, "ocsoftmax")]
    assert len(members) == 2 and not np.allclose(members[0], members[1])
    np.testing.assert_allclose(fused, np.mean(members, axis=0), rtol=1e-5,
                               atol=1e-5)
    _against_jax(fused, jback, feats)


def test_export_raw_waveform_scoring(tmp_path, single):
    jax_run, port_run = single
    meta, back, jback = _export_both(tmp_path, "raw", jax_run, port_run,
                                     batch_size=2, raw=True,
                                     wave_seconds=0.5)
    assert meta["mode"] == "raw"
    n = meta["signature"]["wave"][1]
    assert meta["signature"]["length"] == [2, "int32"]
    wave = np.random.default_rng(3).standard_normal((2, n)).astype(
        np.float32)
    lengths = np.asarray([n, n // 2], np.int32)
    scores = _scores(back, wave, lengths)
    assert scores.shape == (2,) and np.isfinite(scores).all()
    _against_jax(scores, jback, wave, lengths)


def test_export_isolate_scoring_rule(tmp_path):
    """isolate exports the distance-to-center rule the run was selected
    with, not the softmax fallback."""
    jax_run, port_run = _runs(tmp_path, "iso", add_loss="isolate")
    _, back, jback = _export_both(tmp_path, "iso", jax_run, port_run,
                                  batch_size=B)
    feats = np.random.default_rng(4).standard_normal(
        (B, 32, 60)).astype(np.float32)
    got = _scores(back, feats)
    want = _live(port_run, "isolate")[0](feats).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got >= 0).all()              # distances, not softmax scores
    _against_jax(got, jback, feats)


def test_export_rawnet(tmp_path):
    """RawNet2 exports through --raw with its waveform front-end (the GRU
    in the graph); feature-mode export is refused."""
    jax_run, port_run = _runs(tmp_path, "rawnet_run", model="rawnet",
                              add_loss=None, on_the_fly=True,
                              rawnet_args=RAWNET_TINY)
    with pytest.raises(ValueError, match="--raw"):
        p_export.export_system(port_run, str(tmp_path / "r.pt2"),
                               batch_size=2, device="cpu")
    meta, back, jback = _export_both(tmp_path, "rawnet", jax_run, port_run,
                                     batch_size=2, raw=True,
                                     wave_seconds=0.4)
    assert meta["mode"] == "raw"
    n = meta["signature"]["wave"][1]
    assert n == RAWNET_TINY["nb_samp"]
    wave = np.random.default_rng(5).standard_normal((2, n)).astype(
        np.float32)
    lengths = np.full((2,), n, np.int32)
    scores = _scores(back, wave, lengths)
    assert scores.shape == (2,) and np.isfinite(scores).all()
    _against_jax(scores, jback, wave, lengths)


def test_export_int8_quantized(tmp_path, single):
    """Weights-only int8: the artifact loads, scores track the float system
    and JAX's int8 artifact, and the parameter bytes are JAX's."""
    jax_run, port_run = single
    meta, back, jback = _export_both(tmp_path, "q8", jax_run, port_run,
                                     batch_size=B, quantize="int8")
    jmeta = json.load(open(tmp_path / "q8.stablehlo.json"))
    assert meta["quantize"] == "int8"
    assert meta["param_bytes_int8"] == jmeta["param_bytes_int8"]
    assert meta["param_bytes_f32"] == jmeta["param_bytes_f32"]
    assert meta["param_bytes_int8"] < 0.35 * meta["param_bytes_f32"]
    assert meta["quantized_score_max_dev"] < 0.05
    assert 0.5 < meta["quantized_rank_agreement"] <= 1.0
    feats = np.random.default_rng(2).standard_normal(
        (B, 32, 60)).astype(np.float32)
    scores = _scores(back, feats)
    assert scores.shape == (B,) and np.isfinite(scores).all()
    _against_jax(scores, jback, feats)


def _ecapa_run(root, C=64, feat_len=20):
    """A port ECAPA + ang_iso run folder from seeded weights."""
    import dataclasses

    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables, random_flax_variables)
    from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training)

    cfg = TrainConfig(out_fold=str(root), model="ecapa", add_loss="ang_iso",
                      C=C, enc_dim=16, feat_len=feat_len)
    state = setup_training(cfg, 1, device="cpu")[2]
    state.model.load_state_dict(from_flax_variables(random_flax_variables(
        5, C=C, model_scale=8, enc_dim=16)))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    save_checkpoint(os.path.join(root, "best.pt"), state)


def _op_counts(module):
    names = [str(n.target) for n in module.graph.nodes
             if n.op == "call_function"]
    return {op: sum(n == f"{custom_ops.NAMESPACE}.{op}.default"
                    for n in names) for op in custom_ops.OPS}


def test_export_ecapa_keeps_the_kernels_as_custom_ops(tmp_path, capsys):
    """ECAPA's artifact, exported by the CLI on the CPU: the graph holds B2
    three times and B3 once as ``asv_torch`` ops (and B1 once with
    --raw), the saved file reloads and matches the live scorer, and on the
    CPU the ops ran their plain versions (no launch counted)."""
    from asvspoof2021_air_tpu_torch.utils import profiling

    kernels = ("B1", "B2", "B3")
    _ecapa_run(tmp_path / "runs" / "ecapa")
    base = ["--model_folder", str(tmp_path / "runs"), "-n", "ecapa",
            "--batch_size", "2", "--check", "--device", "cpu"]
    launches = [profiling.counts().get(k, 0) for k in kernels]
    art = str(tmp_path / "ecapa.pt2")
    meta = p_export.main(base + ["-o", art])
    assert json.loads(capsys.readouterr().out.strip()) == meta
    back = torch.export.load(art).module()
    assert _op_counts(back) == {"lfcc": 0, "res2_chain": 3,
                                "attention_pooling": 1}
    feats = np.random.default_rng(6).standard_normal(
        (2, 20, 60)).astype(np.float32)
    live = _live(str(tmp_path / "runs" / "ecapa"), "ang_iso")[0]
    np.testing.assert_allclose(_scores(back, feats), live(feats).numpy(),
                               rtol=1e-5, atol=1e-5)
    raw_art = str(tmp_path / "ecapa_raw.pt2")
    meta = p_export.main(base + ["-o", raw_art, "--raw", "--wave_seconds",
                                 "0.2"])
    assert meta["signature"]["wave"] == [2, 3200, "float32"]
    raw_back = torch.export.load(raw_art).module()
    assert _op_counts(raw_back) == {"lfcc": 1, "res2_chain": 3,
                                    "attention_pooling": 1}
    assert [profiling.counts().get(k, 0) for k in kernels] == launches
