"""The port's RawNet2 against the JAX package's, on the CPU at the tiny
arguments of tests/test_train_loop.py (``RAWNET_TINY``: 129 taps, 4/8
filters, a 16-unit GRU, 6400 samples): ``sinc_filterbank`` bit for bit
(also at the default 1024 -> 1025 taps), ``sinc_conv_fft`` against JAX's
and against the time-domain correlation at 64600 samples, the GRU layer,
the model in eval and train mode, the weight map both ways,
``WaveformFrontend``'s tiling bit for bit, and ``score_raw_to_file``
against JAX's. The trajectory and ``train()`` are
tests/test_torch_rawnet_train.py; the converter and ``summarize`` of every
family tests/test_torch_summary.py.

Train-mode gradients are JAX's eager ``jax.grad``: XLA's jitted gradient
of the JAX RawNet2 on the CPU is off the float64 gradient by 0.26 (``
first_bn.weight``), 0.43 (``first_bn.bias``) and 0.52
(``block0.0.conv2.weight``) of those tensors' norms at this seed, where
the eager JAX gradient and the port's f32 are within 2e-5 of it."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asvspoof2021_air_tpu.scoring as jscoring
import asvspoof2021_air_tpu.train.loop as jloop
from asvspoof2021_air_tpu.interop.torch_port import port_rawnet
from asvspoof2021_air_tpu.models import rawnet as jr
from asvspoof2021_air_tpu.models.registry import build_model as j_build
from asvspoof2021_air_tpu.models.summary import parameter_table
from asvspoof2021_air_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from asvspoof2021_air_tpu.train.frontend import (
    WaveformFrontend as JWaveformFrontend)
from asvspoof2021_air_tpu_torch.cli import generate_score as p_cli
from asvspoof2021_air_tpu_torch.interop.checkpoints import (
    rawnet_from_state_dict)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables)
from asvspoof2021_air_tpu_torch.models import rawnet as pr
from asvspoof2021_air_tpu_torch.models.summary import summarize
from asvspoof2021_air_tpu_torch.ops.augment import ChannelAugmenter
from asvspoof2021_air_tpu_torch.scoring import score_raw_to_file
from asvspoof2021_air_tpu_torch.train.frontend import WaveformFrontend
from asvspoof2021_air_tpu_torch.train.loop import TrainConfig, train
from test_torch_resnet import norm_err, rel_err
from test_torch_train import _write_part
from test_torch_train_families import (  # noqa: F401  (the fixture)
    B, ENC, RAWNET_TINY, _fast_jax_init, _two_threads, check_trajectory,
    family_input, family_variables, jax_model, port_model, trajectory)

RUNNING = ("running_mean", "running_var")


def _np(t):
    return t.detach().float().numpy()


def _tree(a):
    return jax.tree.map(np.asarray, a)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("channels,taps", [(20, 1024), (4, 129)])
def test_sinc_filterbank_is_bitwise_jax(channels, taps):
    """The bank, bit for bit: an even ``first_conv`` gets one tap more."""
    got, want = pr.sinc_filterbank(channels, taps), \
        jr.sinc_filterbank(channels, taps)
    assert got.shape == want.shape == (taps | 1, 1, channels)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_sinc_conv_fft_matches_jax_and_the_time_domain():
    """At the default bank and 64600 samples (n = 65536): the port's FFT
    correlation against JAX's and against the port's time-domain
    ``F.conv1d`` (rtol 1e-4, atol 1e-5, JAX's own bar between its two
    forms); RawNet2 whole with either front-end (1e-4)."""
    g = np.random.default_rng(3)
    x = g.standard_normal((2, 64600)).astype(np.float32)
    bank = pr.sinc_filterbank(20, 1024)
    spec = pr.sinc_spectrum(bank, pr.fft_size(64600))
    assert pr.fft_size(64600) == 65536 and spec.dtype == torch.complex64
    got = pr.sinc_conv_fft(torch.from_numpy(x), spec, 1025)
    want = jr.sinc_conv_fft(jnp.asarray(x[..., None]), bank)
    assert got.shape == (2, 20, 64600 - 1024)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), **tol)
    td = torch.nn.functional.conv1d(
        torch.from_numpy(x)[:, None],
        torch.from_numpy(np.ascontiguousarray(bank.transpose(2, 1, 0))))
    np.testing.assert_allclose(got.numpy(), td.numpy(), **tol)
    wav = torch.from_numpy(family_input("rawnet", g, 0, lead=(2,)))
    fft_model = port_model("rawnet", 0).eval()
    td_model = pr.RawNet(RAWNET_TINY, fft_frontend=False, device="cpu")
    td_model.load_state_dict(fft_model.state_dict())
    with torch.no_grad():
        for a, b in zip(fft_model(wav), td_model.eval()(wav)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4)


def test_gru_matches_the_jax_gru_layer():
    """``torch.nn.GRU`` with the JAX ``GRULayer``'s weights mapped
    (``from_flax_variables``' rule): every step's output 1e-5 of the
    largest, and the gradients of their sum of squares for each weight and
    the input within 1e-5 of their norms. Both keep the two bias vectors
    and the r|z|n gate order."""
    g = np.random.default_rng(4)
    x = g.standard_normal((B, 7, 8)).astype(np.float32)
    jm = jr.GRULayer(features=16)
    v = _tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = jax.tree.map(lambda a: a + 0.1 * g.standard_normal(a.shape).astype(
        np.float32), v["params"])
    gru = torch.nn.GRU(8, 16, 1, batch_first=True)
    with torch.no_grad():
        for name, val in (("weight_ih_l0", p["wi"].T), ("weight_hh_l0",
                                                        p["wh"].T),
                          ("bias_ih_l0", p["bi"]), ("bias_hh_l0", p["bh"])):
            getattr(gru, name).copy_(torch.from_numpy(
                np.ascontiguousarray(val)))

    def loss(params, xx):
        y = jm.apply({"params": params}, xx)
        return jnp.sum(y ** 2), y

    (gp, gx), y = jax.grad(loss, (0, 1), has_aux=True)(p, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, _h = gru(tx)
    out.pow(2).sum().backward()
    assert rel_err(_np(out), y) <= 1e-5
    for name, want in (("weight_ih_l0", gp["wi"].T), ("weight_hh_l0",
                                                      gp["wh"].T),
                       ("bias_ih_l0", gp["bi"]), ("bias_hh_l0", gp["bh"])):
        assert norm_err(_np(getattr(gru, name).grad), want) <= 1e-5, name
    assert norm_err(_np(tx.grad), gx) <= 1e-5


def _pair(train: bool):
    g = np.random.default_rng(1)
    x = family_input("rawnet", g, 0)
    v = family_variables("rawnet", x, 1, 0)
    jm = jax_model("rawnet", 0)
    model = port_model("rawnet", 0)
    model.load_state_dict(from_flax_variables(v, model="rawnet"))
    if not train:
        e, lg = jax.jit(jm.apply, static_argnums=2)(v, jnp.asarray(x), False)
        with torch.no_grad():
            pe, pl = model.eval()(torch.from_numpy(x))
        return {"emb": (_np(pe), e), "logp": (_np(pl), lg)}, None, None

    def loss(params):
        (e, lg), mut = jm.apply({"params": params,
                                 "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), True,
                                mutable=["batch_stats"])
        return jnp.sum(e ** 2) + jnp.sum(lg ** 2), (e, lg, mut)

    grads, (e, lg, mut) = jax.grad(loss, has_aux=True)(v["params"])
    model.train()
    pe, pl = model(torch.from_numpy(x))
    (pe.pow(2).sum() + pl.pow(2).sum()).backward()
    out = {"emb": (_np(pe), e), "logp": (_np(pl), lg)}
    want = from_flax_variables(_tree({"params": v["params"],
                                      "batch_stats": mut["batch_stats"]}),
                               model="rawnet")
    for k, t in model.state_dict().items():
        if k.endswith(RUNNING):
            out[k] = (_np(t), want[k].numpy())
    want_g = from_flax_variables(_tree({"params": grads,
                                        "batch_stats": v["batch_stats"]}),
                                 model="rawnet")
    return out, model, want_g


def test_rawnet_eval_matches_jax():
    """Pre-logits and log-probabilities in f32, 1e-4 of the largest
    magnitude (read: 2.1e-6)."""
    pairs, _m, _g = _pair(False)
    for name, (got, want) in pairs.items():
        assert rel_err(got, want) <= 1e-4, name


def test_rawnet_train_mode_matches_jax():
    """Train mode: outputs and every BN running statistic after the
    forward within 1e-4 of their largest magnitude (read: 5.2e-6); every
    parameter gradient of sum pre^2 + sum logp^2 within 5e-3 of its norm
    against JAX's eager gradient (read: 8.7e-5 at most), except two kinds
    the reference's structure makes zero: the unused ``bn1`` of blocks 1-5
    (conv1 reads the raw input) has no gradient in either package, and a
    conv1 bias, which feeds a train-mode BN and so is zero in exact
    arithmetic, is held by its norm, within 1e-6 of the largest gradient's
    in both (read: 1.7e-7)."""
    pairs, model, want_g = _pair(True)
    assert sum(k.endswith(RUNNING) for k in pairs) == 2 * 13
    for name, (got, want) in pairs.items():
        assert rel_err(got, want) <= 1e-4, name
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    largest = max(float(np.linalg.norm(want_g[n].numpy())) for n in grads)
    for n, pg in grads.items():
        want = want_g[n].numpy()
        if ".bn1." in n:
            assert model.get_parameter(n).grad is None, n
            assert not np.any(want), n
        elif ".conv1.bias" in n:
            assert max(float(pg.norm()), float(np.linalg.norm(want))) \
                <= 1e-6 * largest, n
        else:
            assert norm_err(_np(pg), want) <= 5e-3, n


def test_weight_map_inverts_port_rawnet():
    """``from_flax_variables`` is the inverse of the JAX package's
    ``port_rawnet`` bit for bit (both GRU bias vectors, the r|z|n rows); the
    names are the reference's (``first_bn``, ``block{i}.0.{bn1, conv1,
    bn2, conv2, conv_downsample}``, ``fc_attention{i}.0``,
    ``bn_before_gru``, ``gru.*_l{k}``, ``fc1_gru``, ``fc2_gru``), the sinc
    bank holding none; ``rawnet_from_state_dict`` rebuilds the model."""
    x = family_input("rawnet", np.random.default_rng(0), 0)
    v = family_variables("rawnet", x, 0, 0)
    sd = from_flax_variables(v, model="rawnet")
    back = port_rawnet({k: t.numpy() for k, t in sd.items()})
    a, b = _flat(v), _flat(back)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = rawnet_from_state_dict(sd, RAWNET_TINY, device="cpu")
    assert set(model.state_dict()) == set(sd) and not model.training
    assert "block0.0.bn1.weight" not in sd and "block1.0.bn1.weight" in sd
    assert "block2.0.conv_downsample.weight" in sd
    assert {f"gru.{w}_l0" for w in ("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh")} <= set(sd)
    assert not any(k.startswith("sinc") for k in sd)


def test_waveform_frontend_tiles_like_jax():
    """Sample t of an utterance of ``length`` samples reads sample t mod
    length, bit for bit with the JAX ``WaveformFrontend``; with the channel
    augmenter it tiles the augmented buffer (its draws given), and its
    ``eval_view`` drops the augmenter."""
    g = np.random.default_rng(5)
    wave = g.standard_normal((3, 900)).astype(np.float32)
    length = np.array([900, 250, 1], np.int32)
    batch = {"wave": wave, "length": length}
    want = JWaveformFrontend(n_samples=2000)(
        {k: jnp.asarray(v) for k, v in batch.items()}, None)
    fe = WaveformFrontend(2000, device="cpu")
    got = fe({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (3, 2000) and fe.min_samples() == 2000
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    aug = ChannelAugmenter(n_fft=4096, device="cpu")
    fe = WaveformFrontend(2000, augmenter=aug, device="cpu")
    draws = aug.draw((3, 900), torch.Generator().manual_seed(0))
    got = fe({k: torch.from_numpy(v) for k, v in batch.items()}, draws,
             fe.params)
    augmented = aug.apply(torch.from_numpy(wave), draws)[0]
    idx = np.arange(2000)[None] % length[:, None]
    np.testing.assert_array_equal(
        got.numpy(), np.take_along_axis(augmented.numpy(), idx, 1))
    assert fe.eval_view().augmenter is None and fe.augmenter is aug
    with pytest.raises(ValueError, match="rng"):
        fe({k: torch.from_numpy(v) for k, v in batch.items()})


class _Raw:
    """Labeled waveforms of 3000 to 9000 samples (shorter and longer than
    the model's 6400)."""

    def __init__(self, n=10, seed=0):
        g = np.random.default_rng(seed)
        self.items = [((0.2 * g.standard_normal(3000 + 700 * i)).astype(
            np.float32), f"LA_E_{i:06d}", 0, i % 2) for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_score_raw_to_file_matches_jax(tmp_path):
    """``score_raw_to_file`` of RawNet2 through a ``WaveformFrontend`` on
    the CPU against the JAX ``score_raw_to_file`` on the same weights and
    utterances (the softmax rule; atol 1e-4); the feature-file tasks
    refuse RawNet2 (it reads waveforms)."""
    x = family_input("rawnet", np.random.default_rng(6), 0)
    v = family_variables("rawnet", x, 6, 0)
    want = jscoring.score_raw_to_file(
        jax_model("rawnet", 0), v, _Raw(), str(tmp_path / "jax.txt"),
        labeled=True, frontend=JWaveformFrontend(RAWNET_TINY["nb_samp"]),
        batch_size=4)
    got = score_raw_to_file(
        from_flax_variables(v, model="rawnet"), _Raw(),
        str(tmp_path / "port.txt"), labeled=True,
        frontend=WaveformFrontend(RAWNET_TINY["nb_samp"], device="cpu"),
        batch_size=4, model="rawnet", rawnet_args=RAWNET_TINY, device="cpu")
    rows = [[line.split() for line in open(p)] for p in (got, want)]
    assert len(rows[0]) == len(rows[1]) == 10
    assert [(r[0], r[2]) for r in rows[0]] == [(r[0], r[2]) for r in rows[1]]
    np.testing.assert_allclose([float(r[1]) for r in rows[0]],
                               [float(r[1]) for r in rows[1]], atol=1e-4)
    run = tmp_path / "runs" / "raw"
    os.makedirs(run)
    cfg = TrainConfig(model="rawnet", rawnet_args=RAWNET_TINY)
    with open(run / "args.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    torch.save({"step": 0, "model": from_flax_variables(v, model="rawnet"),
                "optimizer": {}, "loss_module": None}, run / "best.pt")
    sd, loss, loaded = p_cli.load_system(str(run), device="cpu")
    assert loss is None and loaded.rawnet_args == RAWNET_TINY
    with pytest.raises(ValueError, match="waveforms"):
        p_cli.main(["--model_folder", str(tmp_path / "runs"), "-n", "raw",
                    "-t", "19dev", "--device", "cpu"])
