"""Ground rules of the PyTorch/CUDA port (asvspoof2021_air_tpu_torch):
it imports neither JAX nor the JAX package, its entry points default to the
GPU and refuse to run on the CPU unless asked, its kernel launchers refuse
CPU tensors, its C entry points match their ctypes signatures, and the
numpy weight maker chip_smoke.py uses matches the flax tree."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asvspoof2021_air_tpu_torch as port
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    random_flax_variables)
from asvspoof2021_air_tpu_torch.ops import _build, _host_build

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    [str(PORT_DIR)], prefix="asvspoof2021_air_tpu_torch."))


def test_importing_every_port_module_pulls_in_no_jax():
    assert "asvspoof2021_air_tpu_torch.scoring" in MODULES
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'asvspoof2021_air_tpu'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|flax)\b|from\s+(jax|jaxlib|flax)[\s.]"
    r"|import\s+asvspoof2021_air_tpu(\.|\s|$)"
    r"|from\s+asvspoof2021_air_tpu(\.|\s))", re.M)


def test_source_scan_finds_no_jax_import():
    # build/ holds compiled kernels and other generated files, not source
    files = sorted(p for p in PORT_DIR.rglob("*.py")
                   if p.relative_to(PORT_DIR).parts[0] != "build")
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        hits = BAD_IMPORT.findall(path.read_text())
        assert not hits, f"{path}: {hits}"
    # the pattern does catch what it must
    assert BAD_IMPORT.search("from asvspoof2021_air_tpu.ops import dsp")
    assert BAD_IMPORT.search("import jax.numpy as jnp")
    assert not BAD_IMPORT.search("from asvspoof2021_air_tpu_torch import x")


def test_entry_points_default_to_cuda_and_refuse_the_cpu(monkeypatch):
    from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC
    from asvspoof2021_air_tpu_torch.ops.lfcc_cuda import CudaLFCC
    from asvspoof2021_air_tpu_torch.scoring import score_raw_to_file
    from asvspoof2021_air_tpu_torch.serving.ecapa_serving import (
        ecapa_apply_serving)
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (LFCC, CudaLFCC, OnDeviceFrontend, ECAPA_TDNN, OCSoftmax,
                 lambda: ecapa_apply_serving({}, torch.zeros(1, 8, 60)),
                 lambda: score_raw_to_file({}, [], "x", True, None)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert LFCC(device="cpu").device.type == "cpu"
    assert OCSoftmax(device="cpu").center.device.type == "cpu"


def test_training_entry_points_default_to_cuda_and_refuse_the_cpu(
        monkeypatch, tmp_path):
    """train, setup_training, the train and eval steps, the CLI and the
    train-mode ECAPA (pooled through FusedSoftmaxStats) raise on a machine
    without CUDA unless asked for the CPU."""
    from asvspoof2021_air_tpu_torch.cli.train import main as cli_main
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.train.loop import (
        TrainConfig, setup_training, train)
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_eval_step, make_train_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(out_fold=str(tmp_path / "run"), model="ecapa",
                      on_the_fly=True, C=16, model_scale=4, enc_dim=8)
    for make in (lambda: train(cfg), lambda: setup_training(cfg, 1),
                 lambda: make_train_step(StepConfig()),
                 lambda: make_eval_step(StepConfig()),
                 lambda: ECAPA_TDNN(C=16, model_scale=4, fused_pool=True),
                 lambda: cli_main(["-o", str(tmp_path / "cli"),
                                   "--on_the_fly"])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert not (tmp_path / "run").exists()
    model = setup_training(cfg, 1, device="cpu")[0]
    assert next(model.parameters()).device.type == "cpu"


def test_c_entry_points_match_ctypes_signatures():
    """Each extern "C" function in csrc/ has as many parameters as its
    ctypes argtypes, pointers where the C side has pointers."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" (?:int|long long) (\w+)\(([^)]*)\)',
                src.read_text()):
            found[name] = [p.strip() for p in params.split(",")]
    assert set(found) == set(_build.SIGNATURES)
    assert {"attn_pool_vjp_forward", "attn_pool_vjp_backward"} <= set(found)
    for name, params in found.items():
        argtypes = _build.SIGNATURES[name]
        assert len(params) == len(argtypes), name
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t is _build.P), (name, p)


def test_weight_maker_matches_flax_init_tree():
    model = JECAPA(C=64, model_scale=8, n_out=2, n_feat=60, enc_dim=32)
    want = model.init({"params": jax.random.PRNGKey(0)},
                      jnp.zeros((1, 16, 60)), False)
    got = random_flax_variables(0, C=64, model_scale=8, enc_dim=32)
    shapes = lambda tree: {
        jax.tree_util.keystr(p): tuple(np.shape(v))
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(got) == shapes(jax.tree.map(np.asarray, want))
    leaves = jax.tree_util.tree_leaves(got)
    assert all(v.dtype == np.float32 for v in leaves)
    again = random_flax_variables(0, C=64, model_scale=8, enc_dim=32)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_kernel_launchers_refuse_cpu_tensors_and_bad_shapes():
    """A kernel launcher never computes on the CPU: it raises before any
    build or launch."""
    from asvspoof2021_air_tpu_torch.ops.attn_pool_cuda import (
        PoolParams, attention_pooling_kernel)
    from asvspoof2021_air_tpu_torch.ops.attn_pool_vjp import (
        softmax_stats_bwd_kernel, softmax_stats_fwd_kernel)
    from asvspoof2021_air_tpu_torch.ops.lfcc import LFCCConfig
    from asvspoof2021_air_tpu_torch.ops.lfcc_cuda import lfcc_kernel
    from asvspoof2021_air_tpu_torch.ops.res2_chain_cuda import (
        res2_chain_kernel)

    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        lfcc_kernel(z(2, 800), z(320), z(256, 2), z(20, 2, dtype=torch.int32),
                    z(24, 20), z(20, 20), LFCCConfig())
    with pytest.raises(ValueError, match="CUDA"):
        res2_chain_kernel(z(2, 10, 512), z(7, 192, 64), z(7, 64), z(7, 64),
                          z(7, 64), dilation=2)
    with pytest.raises(ValueError, match="width"):
        res2_chain_kernel(z(2, 10, 64), z(7, 24, 8), z(7, 8), z(7, 8),
                          z(7, 8), dilation=2)
    with pytest.raises(ValueError, match="cast w"):   # no cast per call
        res2_chain_kernel(z(2, 10, 512, dtype=torch.bfloat16), z(7, 192, 64),
                          z(7, 64), z(7, 64), z(7, 64), dilation=2)
    params = PoolParams(z(256, 128), z(256, 128), z(256, 128), z(128),
                        z(128), z(128), z(128, 256), z(256))
    with pytest.raises(ValueError, match="CUDA"):
        attention_pooling_kernel(z(2, 10, 256), params)
    with pytest.raises(ValueError, match="valid_len"):
        attention_pooling_kernel(z(2, 10, 256), params, valid_len=1)
    x, h2, w2, b2 = z(2, 10, 256), z(2, 10, 128), z(128, 256), z(256)
    with pytest.raises(ValueError, match="CUDA"):
        softmax_stats_fwd_kernel(x, h2, w2, b2)
    with pytest.raises(ValueError, match="CUDA"):
        softmax_stats_bwd_kernel(x, h2, w2, b2, [z(2, 256)] * 4, z(2, 256),
                                 z(2, 256))


def test_int8_and_export_entry_points_default_to_cuda_and_refuse_the_cpu(
        monkeypatch, tmp_path):
    """The int8 tiers, their calibration and the export (function and CLI)
    raise on a machine without CUDA unless asked for the CPU."""
    from asvspoof2021_air_tpu_torch.cli import export
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables)
    from asvspoof2021_air_tpu_torch.serving import ecapa_apply_int8
    from asvspoof2021_air_tpu_torch.serving.ecapa_int8 import (
        calibrate_act_scales)
    from asvspoof2021_air_tpu_torch.serving.ecapa_serving import ServingECAPA

    sd = from_flax_variables(random_flax_variables(0, C=16, model_scale=4,
                                                   enc_dim=8), model_scale=4)
    feats = torch.zeros(2, 12, 60)
    run = tmp_path / "run"
    run.mkdir()
    (run / "args.json").write_text('{"model": "ecapa"}')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ecapa_apply_int8(sd, feats, model_scale=4),
                 lambda: calibrate_act_scales(sd, [feats], model_scale=4),
                 lambda: ServingECAPA(sd, model_scale=4, quantize=True),
                 lambda: export.export_system(str(run), str(tmp_path / "a")),
                 lambda: export.main(["--model_folder", str(tmp_path), "-n",
                                      "run", "-o", str(tmp_path / "a")])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    emb, _ = ecapa_apply_int8(sd, feats, model_scale=4, device="cpu")
    assert emb.shape == (2, 8) and emb.device.type == "cpu"
    with pytest.raises(ValueError, match="quantize"):
        ServingECAPA(sd, model_scale=4, quantize="int4", device="cpu")


def test_custom_ops_have_cuda_cpu_and_fake_kernels():
    """B1, B2 and B3 are registered in ``asv_torch`` with a CUDA kernel (the
    launcher), a CPU kernel (the plain version) and a fake one; on CPU
    tensors an op gives its plain version's result."""
    from asvspoof2021_air_tpu_torch.ops import custom_ops
    from asvspoof2021_air_tpu_torch.ops.res2_chain_cuda import (
        res2_chain_plain)

    for op in custom_ops.OPS:
        name = f"{custom_ops.NAMESPACE}::{op}"
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), \
                (name, key)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 10, 64, generator=g)
    w, cb, a, b = (torch.randn(s, generator=g) for s in
                   ((7, 24, 8), (7, 8), (7, 8), (7, 8)))
    got = torch.ops.asv_torch.res2_chain(x, w, cb, a, b, 2, 8, 7)
    assert torch.equal(got, res2_chain_plain(x, w, cb, a, b, dilation=2,
                                             valid_len=7))


def test_scoring_slice_entry_points_default_to_cuda_and_refuse_the_cpu(
        monkeypatch, tmp_path):
    """The feature-file scorer, its CLI and loaders, the scanned runner and
    the checkpoint loaders raise on a machine without CUDA unless asked
    for the CPU."""
    import asvspoof2021_air_tpu_torch.scoring as scoring
    from asvspoof2021_air_tpu_torch.cli import generate_score
    from asvspoof2021_air_tpu_torch.interop.checkpoints import (
        ecapa_from_state_dict)
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables)
    from asvspoof2021_air_tpu_torch.serving.stream import make_scanned_infer

    sd = from_flax_variables(random_flax_variables(0, C=16, model_scale=4,
                                                   enc_dim=8), model_scale=4)
    run = tmp_path / "run"
    run.mkdir()
    (run / "args.json").write_text('{"model": "ecapa"}')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: scoring.make_score_fn(sd, model_scale=4),
                 lambda: scoring.test_on_asvspoof2021(
                     "LA", sd, {"la_eval": str(tmp_path)}, str(tmp_path),
                     "x", model_scale=4),
                 lambda: generate_score.load_system(str(run)),
                 lambda: generate_score.main([
                     "--model_folder", str(tmp_path), "-n", "run", "-t",
                     "LA"]),
                 lambda: make_scanned_infer(lambda b: b),
                 lambda: ecapa_from_state_dict(sd)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    fn = scoring.make_score_fn(sd, model_scale=4, device="cpu")
    assert fn.device.type == "cpu"
    assert fn(torch.zeros(2, 12, 60)).shape == (2,)
    scan = make_scanned_infer(lambda b: b.sum(-1), device="cpu")
    assert torch.equal(scan(torch.ones(3, 2, 4)), torch.full((3, 2), 4.0))


def test_scoring_cli_runs_with_jax_blocked():
    """``python -m ...cli.generate_score --help`` with jax, flax and the
    JAX package unimportable; the import guards above cover the scoring
    slice's modules."""
    assert {f"asvspoof2021_air_tpu_torch.{m}" for m in (
        "cli.generate_score", "cli.evaluate_tdcf", "cli.prepare4matlab",
        "cli.score_fusion", "fusion", "interop.checkpoints",
        "metrics.evaluate", "metrics.tdcf", "serving.stream")} <= set(MODULES)
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'asvspoof2021_air_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['generate_score', '--help']\n"
        "runpy.run_module('asvspoof2021_air_tpu_torch.cli.generate_score',"
        " run_name='__main__', alter_sys=True)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--scan_batches" in out.stdout and "--dtype" in out.stdout


def test_host_entry_points_match_ctypes_signatures():
    """Each extern "C" function of csrc/host/ has as many parameters as its
    ctypes argtypes in ``_host_build.HOST_SIGNATURES``."""
    found = {}
    for src in sorted(_host_build.HOST_SRC.glob("*.cc")):
        text = src.read_text()
        body = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"\nlong (\w+)\(([^)]*)\)", body):
            found[name] = [p.strip() for p in params.split(",")]
    assert set(found) == set(_host_build.HOST_SIGNATURES) == {
        "flac_stream_info", "flac_decode"}
    for name, params in found.items():
        argtypes, _restype = _host_build.HOST_SIGNATURES[name]
        assert len(params) == len(argtypes), name


def test_family_slice_entry_points_default_to_cuda_and_refuse_the_cpu(
        monkeypatch):
    """ResNet18, LCNN, the one-class losses, the center loss, the
    registries, the checkpoint loaders of the families and the scorer's
    model builder raise on a machine without CUDA unless asked for the
    CPU; each is among the modules the import guard above covers. All six
    names of the JAX ``MODEL_REGISTRY`` build on the CPU and raise without
    a GPU, as do the modules and loaders of SE-Res2Net50, ConvNet,
    Subband and RawNet2 and the waveform front-end."""
    from asvspoof2021_air_tpu_torch.interop.checkpoints import (
        convnet_from_state_dict, lcnn_from_state_dict,
        rawnet_from_state_dict, res2net_from_state_dict,
        resnet_from_state_dict)
    from asvspoof2021_air_tpu_torch.models import (
        ConvNet, RawNet, SERes2Net50, Subband)
    from asvspoof2021_air_tpu_torch.models.registry import MODEL_REGISTRY
    from asvspoof2021_air_tpu_torch.train.frontend import WaveformFrontend
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables)
    from asvspoof2021_air_tpu_torch.losses.basic import CenterLoss
    from asvspoof2021_air_tpu_torch.losses.one_class import (
        AMSoftmax, IsolateLoss, IsolateSquareLoss, P2SGradLoss)
    from asvspoof2021_air_tpu_torch.losses.registry import build_loss
    from asvspoof2021_air_tpu_torch.models.lcnn import LCNN
    from asvspoof2021_air_tpu_torch.models.registry import build_model
    from asvspoof2021_air_tpu_torch.models.resnet import ResNet
    from asvspoof2021_air_tpu_torch.scoring import build_scoring_model

    assert {f"asvspoof2021_air_tpu_torch.{m}" for m in (
        "models.resnet", "models.lcnn", "models.registry", "losses.basic",
        "losses.registry")} <= set(MODULES)
    lcnn_sd = from_flax_variables(random_flax_variables(
        0, model="lcnn", enc_dim=8, feat_len=32), model="lcnn")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ResNet, lambda: LCNN(feat_len=32),
                 lambda: IsolateLoss(8), lambda: IsolateSquareLoss(8),
                 lambda: P2SGradLoss(8), lambda: AMSoftmax(2, 8),
                 lambda: CenterLoss(2, 8),
                 lambda: build_model("lcnn", feat_len=32),
                 lambda: build_loss("isolate", enc_dim=8),
                 lambda: resnet_from_state_dict({}),
                 lambda: lcnn_from_state_dict(lcnn_sd),
                 lambda: build_scoring_model(lcnn_sd, "lcnn")):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert next(LCNN(feat_len=32, device="cpu").parameters()).device.type \
        == "cpu"
    assert build_loss("p2sgrad", enc_dim=8, device="cpu").weight.device.type \
        == "cpu"
    assert sorted(MODEL_REGISTRY) == sorted(
        ("cnn", "resnet", "lcnn", "res2net", "ecapa", "rawnet"))
    tiny = {"nb_samp": 6400, "first_conv": 129, "in_channels": 1,
            "filts": [4, [4, 4], [4, 8], [8, 8]], "blocks": [2, 4],
            "nb_fc_node": 16, "gru_node": 16, "nb_gru_layer": 1,
            "nb_classes": 2}
    kw = dict(feat_len=32, C=16, model_scale=4, rawnet_args=tiny)
    for name in MODEL_REGISTRY:
        model = build_model(name, device="cpu", **kw)
        assert next(model.parameters()).device.type == "cpu", name
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(name, **kw)
    sds = {"res2net": res2net_from_state_dict,
           "cnn": convnet_from_state_dict,
           "rawnet": lambda sd, **d: rawnet_from_state_dict(sd, tiny, **d)}
    for name, load in sds.items():
        sd = build_model(name, device="cpu", **kw).state_dict()
        assert not load(sd, device="cpu").training
        with pytest.raises(RuntimeError, match="cuda"):
            load(sd)
    for make in (SERes2Net50, lambda: ConvNet(feat_len=32),
                 lambda: Subband(feat_len=32), lambda: RawNet(tiny),
                 WaveformFrontend):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_parallel_slice_entry_points_default_to_cuda_and_refuse_the_cpu(
        monkeypatch):
    """The multi-GPU layer (parallel/, the ensemble meshes) is among the
    modules the import guards above cover; its entry points that take a
    device default to the GPU and raise without one unless asked for the
    CPU, initialize_distributed included once the environment names a
    world (it never goes on in one process or on the CPU)."""
    from asvspoof2021_air_tpu_torch.parallel import (
        Mesh, initialize_distributed, make_mesh)
    from asvspoof2021_air_tpu_torch.train.ensemble import (
        ensemble_mesh, member_data_mesh)

    assert {f"asvspoof2021_air_tpu_torch.parallel.{m}"
            for m in ("mesh", "distributed")} <= set(MODULES)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh, lambda: ensemble_mesh(2),
                 lambda: member_data_mesh(1, 1),
                 lambda: Mesh(("data",), (1,), {"data": 0}, {"data": None},
                              "cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert make_mesh("cpu").device.type == "cpu"
    assert ensemble_mesh(2, "cpu").size("model") == 1
    initialize_distributed()        # no world named: nothing to join
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="cuda"):
        initialize_distributed()
    assert not torch.distributed.is_initialized()


def _header_declarations():
    """name -> parameter list of every function native/augment/augment.h
    declares."""
    text = (_host_build.NATIVE_DIR / "augment" / "augment.h").read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    decls = re.findall(r"\n\s*(?:void|long|size_t|uint8_t|int16_t)\s+"
                       r"(\w+)\(([^)]*)\);", text)
    return {name: [p.strip() for p in params.split(",")]
            for name, params in decls}


def _native_definitions():
    """name -> parameter list of every extern "C" function the native
    sources define."""
    found = {}
    for src in _host_build.codec_sources()[0]:
        text = src.read_text()
        for block in text.split('extern "C" {')[1:]:
            for name, params in re.findall(
                    r"\n(?:void|long|size_t|uint8_t|int16_t) (\w+)\("
                    r"([^)]*)\)", block):
                found[name] = [p.strip() for p in params.split(",")]
    return found


def test_codec_entry_points_match_ctypes_signatures():
    """``_host_build.CODEC_SIGNATURES`` holds every one of augment.h's 37
    declarations and the entry points of the native sources the host tier
    calls beyond them; each has as many argument types as its C
    prototype, a pointer exactly where the prototype has one, and a
    result type where the function returns a value."""
    header = _header_declarations()
    assert len(header) == 37
    assert set(header) <= set(_host_build.CODEC_SIGNATURES)
    defined = _native_definitions()
    assert set(_host_build.CODEC_SIGNATURES) <= set(defined)
    for name, (argtypes, restype) in _host_build.CODEC_SIGNATURES.items():
        params = header.get(name, defined[name])
        assert len(params) == len(argtypes), name
        for p, t in zip(params, argtypes):
            assert ("*" in p) == hasattr(t, "contents"), (name, p)
        text = (_host_build.NATIVE_DIR / "augment" / "augment.h").read_text()
        assert (restype is None) == bool(
            re.search(rf"\nvoid {name}\(", text)
            or (name not in header and name in ("amrwb_roundtrip_mode",
                                                "amrwb_roundtrip_dtx_mode",
                                                "g729_roundtrip"))), name


def test_degradation_tier_is_host_only_and_visualize_defaults_to_the_card(
        monkeypatch, tmp_path):
    """``cli.degrade`` and ``data.augment_host`` (and the system codec
    tier) take no device and import no torch (a degrade worker process
    loads without it): they run with CUDA unavailable; ``cli.visualize``
    embeds on the card by default and raises without one unless asked for
    the CPU. All are among the modules the import guards above cover."""
    import inspect

    from asvspoof2021_air_tpu_torch.cli import degrade, visualize
    from asvspoof2021_air_tpu_torch.data import augment_host, system_codecs

    assert {f"asvspoof2021_air_tpu_torch.{m}" for m in (
        "cli.degrade", "cli.visualize", "data.augment_host",
        "data.system_codecs", "interop.avcodec", "visualize",
        "ops.res2_chain_vjp")} <= set(MODULES)
    for mod in (degrade, augment_host, system_codecs):
        src = inspect.getsource(mod)
        for word in ("import torch", "resolve_device", "cuda"):
            assert word not in src, (mod.__name__, word)
    # what a degrade worker process imports, and the codec library's
    # build, load without torch
    code = ("import sys\n"
            "import asvspoof2021_air_tpu_torch.cli.degrade\n"
            "import asvspoof2021_air_tpu_torch.interop.avcodec\n"
            "from asvspoof2021_air_tpu_torch.data import augment_host\n"
            "augment_host.get_lib()\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "False", (
        out.stdout, out.stderr)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = tmp_path / "wav"
    wav.mkdir()
    from asvspoof2021_air_tpu_torch.data.audio_io import write_wav
    write_wav(str(wav / "LA_T_0000001.wav"),
              0.1 * np.sin(np.arange(4000, dtype=np.float32) / 7))
    degrade.main(["channel", "-i", str(wav), "-o", str(tmp_path / "o"),
                  "--fidelity", "native", "--sampling", "random"])
    assert len(list((tmp_path / "o").iterdir())) == 1
    with pytest.raises(SystemExit):
        degrade.main(["channel", "-i", str(wav), "-o", "x", "--device",
                      "cpu"])          # no such flag: host only
    run = tmp_path / "run"
    run.mkdir()
    (run / "args.json").write_text('{"model": "lcnn"}')
    with pytest.raises(RuntimeError, match="cuda"):
        visualize.main(["--model_folder", str(tmp_path), "-n", "run", "-f",
                        str(tmp_path)])


@pytest.mark.parametrize("family", ["res2net", "cnn", "cnn_att", "rawnet",
                                    "subband"])
def test_weight_maker_matches_flax_init_tree_of_every_family(family):
    """``random_flax_variables`` of the four families it gained: the names
    and shapes of the JAX model's ``init`` tree (at the JAX family tests'
    sizes), seeded and f32, and the port's model loads its mapping
    (``from_flax_variables``) strictly."""
    from asvspoof2021_air_tpu.models.convnet import ConvNet as JConvNet
    from asvspoof2021_air_tpu.models.rawnet import RawNet as JRawNet
    from asvspoof2021_air_tpu.models.res2net import SERes2Net50 as JRes2Net
    from asvspoof2021_air_tpu.models.subband import Subband as JSubband
    from asvspoof2021_air_tpu_torch.interop.flax_weights import (
        from_flax_variables)
    from asvspoof2021_air_tpu_torch.models import (
        ConvNet, RawNet, SERes2Net50, Subband)

    tiny = {"nb_samp": 6400, "first_conv": 129, "in_channels": 1,
            "filts": [4, [4, 4], [4, 8], [8, 8]], "blocks": [2, 4],
            "nb_fc_node": 16, "gru_node": 16, "nb_gru_layer": 1,
            "nb_classes": 2}
    T, enc = 32, 16
    x = jnp.zeros((2, T, 60))
    if family == "res2net":
        jm, kw, port = JRes2Net(), {}, lambda: SERes2Net50(device="cpu")
    elif family in ("cnn", "cnn_att"):
        att = family == "cnn_att"
        nodes = 6 if att else 512
        jm = JConvNet(enc_dim=enc, subband_attention=att, num_nodes=nodes)
        kw = {"subband_attention": att, "num_nodes": nodes}
        port = lambda: ConvNet(enc_dim=enc, feat_len=T, device="cpu", **kw)
    elif family == "rawnet":
        jm, kw = JRawNet(d_args=tiny), {"d_args": tiny}
        x = jnp.zeros((2, tiny["nb_samp"]))
        port = lambda: RawNet(tiny, device="cpu")
    else:
        jm, kw = JSubband(num_nodes=60, enc_dim=enc, subband_num=2), {
            "subband_num": 2}
        port = lambda: Subband(enc_dim=enc, subband_num=2, feat_len=T,
                               device="cpu")
    want = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, x, False))
    name = "cnn" if family == "cnn_att" else family
    got = random_flax_variables(0, model=name, enc_dim=enc, feat_len=T,
                                model_kwargs=kw)
    shapes = lambda tree: {
        jax.tree_util.keystr(p): tuple(np.shape(v))
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(got) == shapes(want)
    leaves = jax.tree_util.tree_leaves(got)
    assert all(v.dtype == np.float32 for v in leaves)
    again = random_flax_variables(0, model=name, enc_dim=enc, feat_len=T,
                                  model_kwargs=kw)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)
    port().load_state_dict(from_flax_variables(got, model=name))
