"""The port's unfused training paths against the JAX package's, on the CPU
at small shapes: ``fused_pool`` and ``fused_bn`` off (the JAX models'
``fused_pool=False`` / ``fused_bn=False``, the JAX loop's path off a TPU).

- The BN pairs unfused (``BatchNorm.fused=False``: ReLU -> BN, BN -> ReLU,
  BN -> leaky ReLU through plain autograd) against the JAX BatchNorm with
  the activation applied outside it, in f32 and bf16: the output, the
  running statistics and the gradients of x, the scale and the bias.
  f32: rtol 1e-5 / atol 1e-5 (the fused VJPs' bar,
  tests/test_torch_train.py); bf16: each within 1e-2 of its norm
  (tests/test_torch_train_bf16.py's floor), the statistics 1e-5.
- ECAPA (C = 32, scale 4, B = 8, T = 40) in train mode, f32, at
  ``test_ecapa_train_mode_matches_jax``'s bars; in bf16, train and eval
  mode, at ``test_bf16_ecapa_matches_jax``'s; a 4-step f32 ang_iso
  trajectory at the f32 trajectory bars of tests/test_torch_train.py
  (losses rtol 2e-3, BN statistics and the center atol 5e-3, parameters
  within 2 lr K).
- ResNet18, LCNN, SE-Res2Net50 and ConvNet with ``fused_bn=False``: a
  4-step trajectory each against JAX's at each family's existing bars
  (tests/test_torch_train_families.py's ``check_trajectory``, with the
  arguments of tests/test_torch_resnet_train.py,
  test_torch_train_families.py, test_torch_res2net_train.py and
  test_torch_convnet.py).
- ``cli.train --fused_pool off --fused_bn off`` and the same keys in a
  ``--config`` file train from feature files without reaching
  FusedSoftmaxStats or the recompute VJPs."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from asvspoof2021_air_tpu.models.common import BatchNorm as JBatchNorm
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.cli.train import main as cli_main
from asvspoof2021_air_tpu_torch.models.common import BatchNorm
from test_torch_train import (
    check_ecapa_train_mode, check_ecapa_trajectory, ecapa_trajectory)
from test_torch_train_bf16 import check_bf16_ecapa
from test_torch_train_families import (
    _write_features, check_trajectory, trajectory)
from torch_threads import one_thread  # noqa: F401

disable_tf32()

MODES = ("relu_bn", "bn_relu", "bn_leaky_relu")


def _rel(a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_pair(mode: str, dtype):
    """The JAX model's unfused pair (``models/common.py:204-225`` there;
    ConvNet's leaky ReLU after the BN) as a function of (x, scale, bias,
    mean, var) -> (y, new mean, new var)."""
    bn = JBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                    dtype=dtype)

    def f(x, scale, bias, mean, var):
        v = {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean, "var": var}}
        y, mut = bn.apply(v, nn.relu(x) if mode == "relu_bn" else x,
                          mutable=["batch_stats"])
        if mode == "bn_relu":
            y = nn.relu(y)
        elif mode == "bn_leaky_relu":
            y = nn.leaky_relu(y, 0.1)
        return y, mut["batch_stats"]["mean"], mut["batch_stats"]["var"]

    return f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_unfused_bn_pairs_match_jax(mode, dtype):
    g = np.random.default_rng(MODES.index(mode))
    x = (0.5 + g.standard_normal((8, 12, 16))).astype(np.float32)
    scale = (1 + 0.1 * g.standard_normal(12)).astype(np.float32)
    bias = (0.1 * g.standard_normal(12)).astype(np.float32)
    mean = (0.1 * g.standard_normal(12)).astype(np.float32)
    var = (1 + 0.1 * g.random(12)).astype(np.float32)
    gy = g.standard_normal(x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    # the JAX models are channels-last: (B, T, C)
    xj = jnp.asarray(x.transpose(0, 2, 1), jdt or jnp.float32)
    (y, m, v), pull = jax.vjp(
        _jax_pair(mode, jdt), xj, *map(jnp.asarray, (scale, bias, mean,
                                                     var)))
    dx, dscale, dbias, _, _ = pull((
        jnp.asarray(gy.transpose(0, 2, 1), y.dtype), jnp.zeros_like(m),
        jnp.zeros_like(v)))

    bn = BatchNorm(12, dtype=tdt).train()
    bn.fused = False
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    tx = torch.from_numpy(x).to(tdt or torch.float32).requires_grad_()
    ty = {"relu_bn": bn.relu_bn, "bn_relu": bn.bn_relu,
          "bn_leaky_relu": lambda t: bn.bn_leaky_relu(t, 0.1)}[mode](tx)
    ty.backward(torch.from_numpy(gy).to(ty.dtype))
    assert ty.dtype == (tdt or torch.float32)
    got = {"y": ty.detach().float().numpy().transpose(0, 2, 1),
           "dx": tx.grad.float().numpy().transpose(0, 2, 1),
           "dscale": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy()}
    want = {"y": np.asarray(y, np.float32), "dx": np.asarray(dx, np.float32),
            "dscale": np.asarray(dscale), "dbias": np.asarray(dbias)}
    for name in got:
        if dtype == "float32":
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:
            assert _rel(got[name], want[name]) <= 1e-2, name
    for got_s, want_s in ((bn.running_mean, m), (bn.running_var, v)):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-5)


def test_unfused_ecapa_train_mode_matches_jax():
    """f32, fused_pool and fused_bn off in both packages: embedding and
    logits 5e-4, batch statistics rtol 1e-4 / atol 1e-5, every gradient
    rtol 5e-3 / atol 2e-4 max(1, largest)."""
    check_ecapa_train_mode(fused=False)


@pytest.mark.parametrize("train", [True, False])
def test_unfused_bf16_ecapa_matches_jax(train):
    """bf16, fused_pool and fused_bn off in both packages, at the bars of
    ``test_bf16_ecapa_matches_jax``. ``attention.3``'s bias shifts every
    logit of a channel by one value, which the softmax over T cancels: its
    gradient is rounding noise in both packages, held under 1e-2 of the
    largest gradient element."""
    check_bf16_ecapa(train, fused=False, noise=("attention.3.bias",))


def test_unfused_ecapa_trajectory_tracks_jax():
    """4 f32 ang_iso steps from one mid-training state, fused_pool and
    fused_bn off in both packages (the warm steps too): the bars of the
    fused f32 trajectory."""
    check_ecapa_trajectory(ecapa_trajectory(fused=False))


@pytest.mark.parametrize("family,add_loss,kw", [
    ("resnet", "ang_iso", dict(spread=True)),
    ("lcnn", "p2sgrad", {}),
    ("res2net", "ang_iso", dict(moments=False, norm_bar=0.1)),
    ("cnn", "ang_iso", {}),
])
def test_family_trajectory_with_fused_bn_off_tracks_jax(family, add_loss,
                                                        kw):
    """4 steps of each family with ``fused_bn=False`` in both packages
    (JAX's draws injected), by ``check_trajectory`` with the arguments of
    the family's fused test: ResNet18 with the batch-reversed spread of
    its BN statistics, SE-Res2Net50 without the per-tensor moments and at
    a 10% norm bar (its order-sensitive f32 gradients)."""
    check = {k: v for k, v in kw.items() if k != "spread"}
    t = trajectory(family, add_loss, spread=kw.get("spread", False),
                   fused_bn=False)
    check_trajectory(t, add_loss, **check)


def test_cli_trains_with_fused_off(tmp_path, capsys, monkeypatch):
    """``cli.train -m ecapa --fused_pool off --fused_bn off`` from feature
    files on the CPU, then the same from a ``--config`` file holding the
    two keys: each trains one epoch (summary printed, best.pt written)
    without calling FusedSoftmaxStats or a recompute VJP of
    ``ops/bn_relu_vjp.py``."""
    import asvspoof2021_air_tpu_torch.models.common as common
    import asvspoof2021_air_tpu_torch.models.ecapa as ecapa

    def refused(*a, **k):
        raise AssertionError("an unfused run reached a fused path")

    for mod, name in ((ecapa, "fused_softmax_stats"),
                      (common, "relu_bn_train"), (common, "bn_train")):
        monkeypatch.setattr(mod, name, refused)
    T = 40
    feats = str(tmp_path / "feats")
    _write_features(feats, "train", 16, 0, T)
    _write_features(feats, "dev", 8, 1, T)
    base = ["-f", feats, "-m", "ecapa", "--add_loss", "ang_iso",
            "--device", "cpu", "--C", "32", "--model_scale", "4",
            "--enc_dim", "16", "--feat_len", str(T), "--batch_size", "8",
            "--num_epochs", "1", "--ratio", "1.0"]
    out = str(tmp_path / "flags")
    cli_main(base + ["-o", out, "--fused_pool", "off", "--fused_bn", "off"])
    path = tmp_path / "args.json"
    path.write_text(json.dumps({"fused_pool": "off", "fused_bn": "off"}))
    out2 = str(tmp_path / "config")
    cli_main(base + ["-o", out2, "--config", str(path)])
    printed = capsys.readouterr().out
    assert printed.count("'dev_eer'") == 2
    for run in (out, out2):
        with open(os.path.join(run, "args.json")) as f:
            args = json.load(f)
        assert (args["fused_pool"], args["fused_bn"]) == ("off", "off")
        assert os.path.exists(os.path.join(run, "best.pt"))
