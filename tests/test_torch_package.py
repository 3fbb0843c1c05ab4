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
from asvspoof2021_air_tpu_torch.ops import _build

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
