"""The port's training of the LCNN and ResNet18 families against the JAX
package, on the CPU at small shapes: 4-step trajectories of LCNN with
p2sgrad and iso_sq from one mid-training state, with the JAX model's own
dropout masks injected into the port's steps; the model's draws as a
function of (seed, step); ``train()`` and the training CLI with their
defaults (``-m lcnn``), ResNet from feature files, ADV_AUG with ang_iso on
LCNN; and ``cli.generate_score`` over a ResNet + isolate run against the
JAX CLI. The ResNet trajectories are tests/test_torch_resnet_train.py,
which shares this file's helpers.

The JAX models run with ``fused_bn=True`` (the recompute VJPs), as the
port always trains. Its draws are recorded from the JAX model's own
train-mode forward under the JAX step's keys (``jax.random.bernoulli`` for
LCNN's dropout, ``jax.random.normal`` for ResNet's pooling noise), in one
jitted forward per step that returns them; the draws do not depend on the
parameters, and JAX's PRNG gives the same bits jitted or not."""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asvspoof2021_air_tpu.cli.generate_score as j_cli
import asvspoof2021_air_tpu.scoring as jscoring
import asvspoof2021_air_tpu.train.loop as jloop
from asvspoof2021_air_tpu.interop.torch_port import port_resnet
from asvspoof2021_air_tpu.losses import build_loss as j_build_loss
from asvspoof2021_air_tpu.models.convnet import ConvNet as JConvNet
from asvspoof2021_air_tpu.models.lcnn import LCNN as JLCNN
from asvspoof2021_air_tpu.models.rawnet import RawNet as JRawNet
from asvspoof2021_air_tpu.models.res2net import SERes2Net50 as JRes2Net
from asvspoof2021_air_tpu.models.resnet import ResNet as JResNet
from asvspoof2021_air_tpu.train import state as jstate
from asvspoof2021_air_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from asvspoof2021_air_tpu.train.steps import StepConfig as JStepConfig
from asvspoof2021_air_tpu.train.steps import make_train_step as j_make_step
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.cli import generate_score as p_cli
from asvspoof2021_air_tpu_torch.cli.train import main as cli_main
from asvspoof2021_air_tpu_torch.data import protocol as proto
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_train_state, from_flax_variables, random_flax_variables)
from asvspoof2021_air_tpu_torch.losses.registry import build_loss
from asvspoof2021_air_tpu_torch.models.convnet import ConvNet
from asvspoof2021_air_tpu_torch.models.registry import build_model
from asvspoof2021_air_tpu_torch.train.checkpoint import save_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import (
    TrainConfig, setup_training, train)
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import (
    StepConfig, make_multi_step, make_train_step)
from test_torch_scoring import (
    assert_same_score_files, feature_trees, shared_jax_make_score_fn)
from test_torch_train import _write_part

B, ENC, LR, WARM, K = 8, 16, 5e-4, 2, 4
# frames of a family's features; RawNet2's waveforms have RAWNET_TINY's
# nb_samp samples. "cnn_att" is ConvNet with subband_attention (6 rows
# leave its layer 4 for 60-dim features), which no registry name builds.
FRAMES = {"resnet": 32, "lcnn": 48, "res2net": 24, "cnn": 32,
          "cnn_att": 32, "rawnet": 0}
# the JAX package's tiny RawNet2 (tests/test_train_loop.py)
RAWNET_TINY = {
    "nb_samp": 6400, "first_conv": 129, "in_channels": 1,
    "filts": [4, [4, 4], [4, 8], [8, 8]], "blocks": [2, 4],
    "nb_fc_node": 16, "gru_node": 16, "nb_gru_layer": 1, "nb_classes": 2,
}
# the embedding width of each family at these sizes
EMB = {"resnet": ENC, "lcnn": ENC, "cnn": ENC, "cnn_att": ENC,
       "res2net": 256, "rawnet": 2}

disable_tf32()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch runs: beside the suite's
    other workers, a thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_model(family: str, T: int, dtype=None):
    """The JAX model as the port trains it (fused_bn=True)."""
    if family == "resnet":
        return JResNet(num_nodes=3, enc_dim=ENC, dtype=dtype, fused_bn=True)
    if family == "res2net":
        return JRes2Net(fused_bn=True)
    if family in ("cnn", "cnn_att"):
        return JConvNet(enc_dim=ENC, subband_attention=family == "cnn_att",
                        num_nodes=6, fused_bn=True)
    if family == "rawnet":
        return JRawNet(d_args=RAWNET_TINY)
    return JLCNN(num_nodes=60, enc_dim=ENC, feat_len=T, dtype=dtype,
                 fused_bn=True)


def port_model(family: str, T: int, dtype=None):
    if family == "cnn_att":
        return ConvNet(enc_dim=ENC, subband_attention=True, num_nodes=6,
                       device="cpu")
    return build_model(family, enc_dim=ENC, feat_len=T, dtype=dtype,
                       rawnet_args=RAWNET_TINY, device="cpu")


def flax_name(family: str) -> str:
    """The ``from_flax_variables`` model name of a test family."""
    return "cnn" if family == "cnn_att" else family


def family_input(family: str, g: np.random.Generator, T: int,
                 lead=(B,)) -> np.ndarray:
    """Seeded f32 inputs of ``lead`` utterances: (..., T, 60) features, or
    RawNet2's (..., nb_samp) waveforms."""
    shape = ((*lead, RAWNET_TINY["nb_samp"]) if family == "rawnet"
             else (*lead, T, 60))
    return g.standard_normal(shape).astype(np.float32)


_VARIABLES = {}


def family_variables(family: str, x: np.ndarray, seed: int, T: int):
    """Seeded numpy variables of the JAX ``family`` model: ResNet18's and
    LCNN's from ``random_flax_variables``; the others' from the JAX model's
    own init (jitted, once per family and input shape) at ``seed``, every
    BN's scale, bias and statistics perturbed by 0.05 so that the eval
    affine is not the identity."""
    if family in ("resnet", "lcnn"):
        return random_flax_variables(seed, model=family, enc_dim=ENC,
                                     feat_len=T)
    model = jax_model(family, T)
    key = (family, x.shape)
    if key not in _VARIABLES:
        _VARIABLES[key] = jax.jit(lambda k, a: model.init(
            {"params": k}, a, False), static_argnums=())
    v = jax.tree.map(np.asarray, _VARIABLES[key](jax.random.PRNGKey(seed),
                                                 jnp.asarray(x)))
    g = np.random.default_rng(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return a
        if name.endswith("['var']"):
            return (a + 0.05 * g.random(a.shape)).astype(np.float32)
        return (a + 0.05 * g.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, v)


def draw_recorder(model):
    """A jitted (variables, x, rng) -> the draw the JAX model's train-mode
    forward makes under the JAX train step's keys for ``rng`` (its
    ``dropout`` stream, and ``noise`` = fold_in(rng, 1)): LCNN's dropout
    mask (``jax.random.bernoulli``) or ResNet's or ConvNet's standard-
    normal pooling noise (``jax.random.normal``), as the forward computes
    it; None for a model that draws none, a tuple for one that draws
    several (Subband: a mask per band)."""

    def fn(variables, x, rng):
        taken = []

        def tap(f):
            def wrapped(*a, **kw):
                out = f(*a, **kw)
                taken.append(out)
                return out
            return wrapped

        normal, bernoulli = jax.random.normal, jax.random.bernoulli
        jax.random.normal, jax.random.bernoulli = tap(normal), tap(bernoulli)
        try:
            model.apply(variables, x, True, mutable=["batch_stats"],
                        rngs={"dropout": rng,
                              "noise": jax.random.fold_in(rng, 1)})
        finally:
            jax.random.normal, jax.random.bernoulli = normal, bernoulli
        # none (SE-Res2Net50, RawNet2, ConvNet), one, or one per band
        # (Subband's LCNNs)
        return None if not taken else taken[0] if len(taken) == 1 \
            else tuple(taken)

    return jax.jit(fn)


def port_draws(family: str, draw: np.ndarray, rows: int = 3
               ) -> torch.Tensor:
    """A JAX draw in the port's layout: ResNet's noise (B, T', 256) and
    ConvNet's (B, T', 128) as they are; LCNN's dropout mask over the NHWC
    flatten (h, w, c) permuted to the port's NCHW flatten (c, h, w), 32
    channels over H = ``rows`` rows (60 // 16). None for a family that
    draws none."""
    if draw is None:
        return None
    if family == "lcnn":
        n = draw.shape[0]
        draw = draw.reshape(n, rows, -1, 32).transpose(0, 3, 1, 2).reshape(
            n, -1)
    return torch.from_numpy(np.ascontiguousarray(draw))


_INIT = {}


def jax_state(model, loss_mod, x0, labels, sched, enc: int = ENC):
    """A JAX ``TrainState`` as ``create_train_state`` builds it, the
    model's init jitted once per model and input shape (its eager init of
    ResNet18 takes 20 s on the CPU)."""
    key = (repr(model), x0.shape)     # RawNet's d_args is a dict
    if key not in _INIT:
        _INIT[key] = jax.jit(lambda k: model.init({"params": k}, x0, True))(
            jax.random.PRNGKey(0))
    variables = _INIT[key]
    btx = jstate.make_backbone_optimizer(sched)
    ltx = lp = None
    if loss_mod is not None:
        ltx = jstate.make_loss_optimizer(sched)
        lp = loss_mod.init(jax.random.PRNGKey(1), jnp.zeros((B, enc)),
                           labels)["params"]
    state = jstate.TrainState(
        step=0, params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=btx.init(variables["params"]), loss_params=lp,
        loss_opt_state=None if lp is None else ltx.init(lp))
    return state, btx, ltx


_RECORDERS = {}


def recorder(model):
    """:func:`draw_recorder`, one per model."""
    if repr(model) not in _RECORDERS:
        _RECORDERS[repr(model)] = draw_recorder(model)
    return _RECORDERS[repr(model)]


def trajectory_batches(family: str):
    """The WARM + K seeded batches of :func:`trajectory` and their labels,
    the bona fide rows shifted by 0.5."""
    g = np.random.default_rng(0)
    labels = (np.arange(B) % 2).astype(np.int32)
    feats = family_input(family, g, FRAMES[family], lead=(WARM + K, B))
    feats += 0.5 * labels.reshape((1, B) + (1,) * (feats.ndim - 2))
    return feats, labels


@contextlib.contextmanager
def given_draws(draw):
    """While open, the JAX model's ``jax.random.normal`` and
    ``jax.random.bernoulli`` return ``draw`` (one array, or a tuple in the
    order the forward draws them) in place of drawing; inside a function
    being jitted, ``draw`` may be its argument."""
    queue = list(draw) if isinstance(draw, tuple) else [draw]
    normal, bernoulli = jax.random.normal, jax.random.bernoulli
    jax.random.normal = jax.random.bernoulli = lambda *a, **k: queue.pop(0)
    try:
        yield
    finally:
        jax.random.normal, jax.random.bernoulli = normal, bernoulli


def reversed_draw(draw):
    """A recorded draw (None, an array or a tuple) with its batch rows in
    reverse order."""
    if draw is None:
        return None
    if isinstance(draw, tuple):
        return tuple(reversed_draw(d) for d in draw)
    return np.ascontiguousarray(np.asarray(draw)[::-1])


def _port_steps(family: str, add_loss, weight_loss: float, start: dict,
                batches, draws):
    """The port's steps from ``start`` over ``batches`` ((feat, label)
    arrays) with JAX's ``draws``: (the train state's state_dict, the
    metrics of each step)."""
    pstate = create_train_state(
        port_model(family, FRAMES[family]),
        build_loss(add_loss, enc_dim=EMB[family], r_real=0.9, r_fake=0.2,
                   alpha=20.0, device="cpu"),
        step_decay_schedule(LR, 0.5, 1, 2))
    pstate.load_state_dict(start)
    pstep = make_train_step(StepConfig(add_loss=add_loss,
                                       weight_loss=weight_loss),
                            device="cpu")
    metrics = []
    for (f, lab), d in zip(batches, draws):
        m = pstep(pstate, {"feat": torch.from_numpy(f),
                           "label": torch.from_numpy(lab)},
                  model_draws=port_draws(family, d))
        metrics.append({k: float(v) for k, v in m.items()})
    return pstate.state_dict(), metrics


def trajectory(family: str, add_loss, weight_loss: float = 1.0,
               jit: bool = True, spread: bool = False):
    """WARM JAX steps from init (non-trivial Adam moments and loss
    parameters), the state carried across by ``from_flax_train_state``,
    then K steps in each package on the same batches, the port's steps
    given the JAX step's own draws. The rate halves every 2 steps, so the
    schedule changes inside the K steps. ``jit=False`` runs the JAX step
    eagerly (RawNet2: XLA's jitted gradient of the JAX model is off, see
    tests/test_torch_rawnet.py). ``spread`` runs the K steps again in each
    package from the same state on every batch with its rows (and the
    draws' rows) reversed, the same steps in exact arithmetic: the model
    after them under "rev_end" (JAX) and "rev_got" (the port)."""
    T = FRAMES[family]
    feats, labels = trajectory_batches(family)
    model = jax_model(family, T)
    loss_mod = j_build_loss(add_loss, enc_dim=EMB[family], r_real=0.9,
                            r_fake=0.2, alpha=20.0)
    sched = jstate.step_decay_schedule(LR, 0.5, 1, 2)
    state, btx, ltx = jax_state(model, loss_mod, jnp.asarray(feats[0]),
                                jnp.asarray(labels), sched, EMB[family])
    cfg = JStepConfig(add_loss=add_loss, weight_loss=weight_loss)
    j_step = j_make_step(model, loss_mod, btx, ltx, cfg)
    step = jax.jit(j_step) if jit else j_step
    record = recorder(model)
    key = jax.random.PRNGKey(1)
    batch = lambda s: {"feat": jnp.asarray(feats[s]),
                       "label": jnp.asarray(labels)}
    for s in range(WARM):
        state, _ = step(state, batch(s), key)
    name = flax_name(family)
    start = from_flax_train_state(jax.device_get(state), model=name)
    mid = state
    j_metrics, draws = [], []
    for s in range(WARM, WARM + K):
        variables = {"params": state.params,
                     "batch_stats": state.batch_stats}
        d = record(variables, jnp.asarray(feats[s]),
                   jax.random.fold_in(key, state.step))
        draws.append(None if d is None else np.array(d))
        state, m = step(state, batch(s), key)
        j_metrics.append({k: float(v) for k, v in m.items()})
    end = from_flax_train_state(jax.device_get(state), model=name)
    ks = range(WARM, WARM + K)
    got, p_metrics = _port_steps(family, add_loss, weight_loss, start,
                                 [(feats[s], labels) for s in ks], draws)
    out = dict(start=start, end=end, got=got, j_metrics=j_metrics,
               p_metrics=p_metrics, draws=draws)
    if spread:
        def given(state, b, key, draw):
            with given_draws(draw):
                return j_step(state, b, key)

        given = jax.jit(given) if jit else given
        rows = [(np.ascontiguousarray(feats[s][::-1]), labels[::-1].copy())
                for s in ks]
        rev_draws = [reversed_draw(d) for d in draws]
        state = mid
        for (f, lab), d in zip(rows, rev_draws):
            b = {"feat": jnp.asarray(f), "label": jnp.asarray(lab)}
            state, _ = (step(state, b, key) if d is None
                        else given(state, b, key, d))
        out["rev_end"] = from_flax_train_state(jax.device_get(state),
                                               model=name)["model"]
        out["rev_got"] = _port_steps(family, add_loss, weight_loss, start,
                                     rows, rev_draws)[0]["model"]
    return out


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def check_updates(t, moments: bool = True, norm_bar: float = 0.05,
                  noise: tuple = ()) -> None:
    """The model's and the loss module's updates (end - start) and the
    change of the model's Adam moments against JAX's. Per model tensor:
    the cosine of the two updates at least 0.9 and their norms within 5%
    of each other, the change of each moment (exp_avg, exp_avg_sq) within
    0.1 of JAX's change by norm; over the whole model the update's error
    within 5e-2 of its norm. Per loss-module element: the update within
    0.1 of JAX's largest. A frozen tensor, a step of the wrong sign or
    scale, or a gradient scaled or taken of another loss each fails one of
    these. Read at these seeds (the five trajectories): cosine 0.974 at
    least, norms 0.993-1.004 of JAX's, moment changes 4.8e-2 at most, the
    model's error 1.26e-2 of its norm at most, the loss module's 2.2e-4.
    Not per element: in LCNN + iso_sq one MFM comparison of the first step
    (one of 276480 at conv3) falls on the other side in each package, and
    Adam turns the gradient that moves into steps of up to the rate in
    2887 elements; ResNet's ReLUs do so in up to 287."""
    start, end, got = t["start"], t["end"], t["got"]
    diff = norm = 0.0
    for k, opt in end["optimizer"].items():
        du = got["model"][k] - start["model"][k]
        dw = end["model"][k] - start["model"][k]
        if _norm(dw) == 0:      # fc_mu.bias under an add-loss: no gradient
            assert _norm(du) == 0, k
            continue
        if any(n in k for n in noise):
            continue            # a gradient of rounding noise alone
        cos = float((du.double().flatten() @ dw.double().flatten())
                    / (_norm(du) * _norm(dw)))
        assert cos >= 0.9, (k, cos)
        assert abs(_norm(du) / _norm(dw) - 1) <= norm_bar, (k, _norm(du),
                                                        _norm(dw))
        diff += _norm(du - dw) ** 2
        norm += _norm(dw) ** 2
        for m in ("exp_avg", "exp_avg_sq") if moments else ():
            s0 = start["optimizer"][k][m]
            err = _norm(got["optimizer"][k][m] - opt[m]) / _norm(opt[m] - s0)
            assert err <= 0.1, (k, m, err)
    assert diff ** 0.5 <= 5e-2 * norm ** 0.5, (diff ** 0.5, norm ** 0.5)
    for k, w in (end["loss_module"] or {}).items():
        dw = w - start["loss_module"][k]
        du = got["loss_module"][k] - start["loss_module"][k]
        np.testing.assert_allclose(du.numpy(), dw.numpy(), rtol=0,
                                   atol=0.1 * float(dw.abs().max()),
                                   err_msg=f"loss module {k} update")


def check_trajectory(t, add_loss, moments: bool = True,
                     norm_bar: float = 0.05, noise: tuple = ()) -> None:
    """Losses rtol 2e-3 (every metric the JAX step logs: the base CE, the
    add-loss, the total); BN running statistics and the loss module's
    parameters atol 5e-3; the model's parameters within 2 lr K (Adam turns
    noise-level gradient differences into steps of up to lr); the updates
    and Adam moments by :func:`check_updates` (the moments not with
    ``moments=False``; each tensor's update norm within ``norm_bar`` of
    JAX's; the tensors named in ``noise``, whose gradient is zero in exact
    arithmetic, only by the parameters' bar). Where ``t`` holds the runs
    with the batches reversed (``trajectory(spread=True)``), a BN
    statistic's bar is max(5e-3, 4 (s_jax + s_port)), s being each
    package's own spread: its largest change under the reversal."""
    names = set(t["j_metrics"][0])
    assert names == set(t["p_metrics"][0]) == (
        {"base_loss", "total_loss"} | ({add_loss} if add_loss else set()))
    for name in names:
        np.testing.assert_allclose([m[name] for m in t["p_metrics"]],
                                   [m[name] for m in t["j_metrics"]],
                                   rtol=2e-3, err_msg=name)
    assert t["got"]["step"] == t["end"]["step"] == WARM + K
    want, got = t["end"]["model"], t["got"]["model"]
    assert set(got) == set(want)
    for k, w in want.items():
        stat = k.endswith(("running_mean", "running_var"))
        atol = 5e-3 if stat else 2 * LR * K
        if stat and "rev_end" in t:
            s_jax = float((t["rev_end"][k] - w).abs().max())
            s_port = float((t["rev_got"][k] - got[k]).abs().max())
            atol = max(atol, 4 * (s_jax + s_port))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    if add_loss is None:
        assert t["got"]["loss_module"] is t["end"]["loss_module"] is None
    else:
        for k, w in t["end"]["loss_module"].items():
            np.testing.assert_allclose(t["got"]["loss_module"][k].numpy(),
                                       w.numpy(), rtol=0, atol=5e-3,
                                       err_msg=k)
            assert not torch.equal(w, t["start"]["loss_module"][k]), k
    assert set(t["got"]["optimizer"]) == set(t["end"]["optimizer"])
    check_updates(t, moments, norm_bar, noise)


@pytest.mark.parametrize("add_loss", ["p2sgrad", "iso_sq"])
def test_lcnn_trajectory_tracks_jax_with_its_dropout(add_loss):
    """LCNN, 4 steps, JAX's dropout masks (rate 0.7) injected: p2sgrad
    (the total is the loss alone) and iso_sq at weight_loss 0.5 (the total
    is loss x weight)."""
    w = 0.5 if add_loss == "iso_sq" else 1.0
    t = trajectory("lcnn", add_loss, weight_loss=w)
    check_trajectory(t, add_loss)
    keep = np.mean([d.mean() for d in t["draws"]])
    assert t["draws"][0].shape == (B, 32 * 3 * (FRAMES["lcnn"] // 16))
    assert t["draws"][0].dtype == np.bool_ and 0.2 < keep < 0.4
    for j, p in zip(t["j_metrics"], t["p_metrics"]):
        np.testing.assert_allclose(p["total_loss"], w * p[add_loss],
                                   rtol=1e-6)
        np.testing.assert_allclose(j["total_loss"], w * j[add_loss],
                                   rtol=1e-6)


def test_model_draws_are_a_function_of_seed_and_step():
    """The step's draws for LCNN and ResNet: the same (seed, step) draws
    the same, another step or seed draws otherwise; a model without draws
    (ECAPA) has none; K steps of a multi-step call equal K single steps
    bitwise; a model that draws needs the run's seed."""
    step = make_train_step(StepConfig(add_loss="ang_iso"), device="cpu")
    feat = torch.zeros(B, FRAMES["lcnn"], 60)
    lcnn = port_model("lcnn", FRAMES["lcnn"])
    a, a2, b, c = (step.draw_model(seed, s, lcnn, {"feat": feat})
                   for seed, s in ((7, 0), (7, 0), (7, 1), (8, 0)))
    assert a.dtype == torch.bool and a.shape == (B, lcnn.flat)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    assert not torch.equal(a, c)
    resnet = port_model("resnet", FRAMES["resnet"])
    noise = step.draw_model(7, 0, resnet,
                            {"feat": torch.zeros(B, 750, 60)})
    assert noise.shape == (B, 94, 256) and noise.dtype == torch.float32
    ecapa = build_model("ecapa", C=16, model_scale=4, enc_dim=ENC,
                        device="cpu")
    assert step.draw_model(7, 0, ecapa, {"feat": feat}) is None

    g = np.random.default_rng(3)
    batches = {"feat": torch.from_numpy(g.standard_normal(
        (2, B, FRAMES["lcnn"], 60)).astype(np.float32)),
        "label": torch.from_numpy((np.arange(2 * B) % 2).reshape(2, B))}
    runs = []
    for multi in (False, True):
        torch.manual_seed(0)
        state = create_train_state(
            port_model("lcnn", FRAMES["lcnn"]),
            build_loss("ang_iso", enc_dim=ENC, device="cpu"),
            step_decay_schedule(LR, 0.5, 1, 2))
        if multi:
            m = make_multi_step(step, 2)(state, batches, 7)
        else:
            ms = [step(state, {k: v[i] for k, v in batches.items()}, 7)
                  for i in range(2)]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((m, state.state_dict()))
    (m1, s1), (m2, s2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(v, s2["model"][k]) for k, v in s1["model"].items())
    with pytest.raises(ValueError, match="seed"):
        step(state, {k: v[0] for k, v in batches.items()})


# ---- train() and the CLIs ----

def _write_features(root, part, n, seed, T, suffix=""):
    """n (1, T', 60) LFCC-shaped .npy files named as the reference cache
    names them, T' around T; spoof items shifted."""
    d = os.path.join(root, part, "LFCC")
    os.makedirs(d)
    g = np.random.default_rng(seed)
    channels = proto.LA_CHANNELS[1:]
    for i in range(n):
        label = i % 2
        x = g.standard_normal((1, T + 3 * (i % 5) - 6, 60)) + 0.7 * label
        sfx = f"_{channels[i % len(channels)]}" if suffix else ""
        name = (f"{i:06d}_LA_T_{1000000 + i}_{'A01' if label else '-'}_"
                f"{'spoof' if label else 'bonafide'}{sfx}")
        np.save(os.path.join(d, name + ".npy"), x.astype(np.float32))


def _log_rows(out, name):
    with open(os.path.join(out, name)) as f:
        return [line.split() for line in f.readlines()[1:]]


def test_cli_trains_lcnn_by_default_on_the_fly(tmp_path, capsys):
    """``cli.train`` with the JAX CLI's defaults (``-m lcnn``, no
    add-loss) on the fly from a wav corpus, on the CPU: one epoch, the
    summary printed, the run folder written with model 'lcnn'."""
    db = str(tmp_path / "db")
    _write_part(db, "train", 8, 2, 7000)
    _write_part(db, "dev", 8, 3, 7000)
    out = str(tmp_path / "out")
    cli_main(["-d", db, "-o", out, "--on_the_fly", "--device", "cpu",
              "--enc_dim", str(ENC), "--feat_len", str(FRAMES["lcnn"]),
              "--batch_size", "8", "--num_epochs", "1", "--ratio", "1.0"])
    assert "'dev_eer'" in capsys.readouterr().out
    with open(os.path.join(out, "args.json")) as f:
        args = json.load(f)
    assert (args["model"], args["add_loss"]) == ("lcnn", None)
    assert os.path.exists(os.path.join(out, "best.pt"))
    rows = _log_rows(out, "train_loss.log")
    assert len(rows) == 1 and np.isfinite(float(rows[0][2]))


@pytest.mark.parametrize("family,add_loss,dtype,k", [
    ("resnet", "isolate", "float32", 2), ("lcnn", "p2sgrad", "bfloat16", 1)])
def test_train_from_feature_files(tmp_path, family, add_loss, dtype, k):
    """Two epochs of ``train()`` from feature files in f32 and bf16, one
    and two steps per call: the logs, the summary (dev loss of the
    add-loss, dev EER), BN statistics and the loss module moved; the
    dev pass scores by the add-loss's rule."""
    T = FRAMES[family]
    ori = str(tmp_path / "ori")
    _write_features(ori, "train", 16, 0, T)
    _write_features(ori, "dev", 8, 1, T)
    cfg = TrainConfig(out_fold=str(tmp_path / "out"), path_to_features=ori,
                      model=family, add_loss=add_loss, batch_size=B,
                      feat_len=T, enc_dim=ENC, num_epochs=2,
                      compute_dtype=dtype, steps_per_call=k)
    init = setup_training(cfg, 2, device="cpu")[2].state_dict()
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    assert 0 <= summary["dev_eer"] <= 1
    assert state.step == 4 and len(_log_rows(cfg.out_fold,
                                             "train_loss.log")) == 4
    live = state.state_dict()
    stats = [n for n in live["model"] if n.endswith("running_var")]
    assert stats and all(not torch.equal(live["model"][n], init["model"][n])
                         for n in stats)
    for n, v in live["loss_module"].items():
        assert not torch.equal(v, init["loss_module"][n]), n
    _, _, _, _, eval_step = setup_training(cfg, 2, device="cpu")
    x = torch.randn(B, T, 60)
    metrics, score, emb = eval_step(state, {"feat": x,
                                            "label": torch.zeros(B)})
    assert set(metrics) == {"base_loss", add_loss}
    want = (torch.linalg.vector_norm(emb - state.loss_module.center, dim=1)
            if add_loss == "isolate" else state.loss_module(emb,
                                                            torch.zeros(B))[1])
    torch.testing.assert_close(score, want)


def test_adv_aug_with_ang_iso_trains_lcnn(tmp_path):
    """ADV_AUG + ang_iso on LCNN from LA_aug feature files (the JAX step's
    ADV branch does not look at the model): two epochs, the gate on in the
    second, the channel classifier moves, the adversarial metrics are
    finite."""
    T = FRAMES["lcnn"]
    ori, aug = str(tmp_path / "ori"), str(tmp_path / "aug")
    for root, sfx in ((ori, ""), (aug, "aug")):
        _write_features(root, "train", 8, 4, T, sfx)
        _write_features(root, "dev", 8, 5, T, sfx)
    cfg = TrainConfig(out_fold=str(tmp_path / "out"), path_to_features=ori,
                      path_to_aug_features=aug, LA_aug=True, ADV_AUG=True,
                      model="lcnn", add_loss="ang_iso", batch_size=B,
                      feat_len=T, enc_dim=ENC, num_epochs=2, ratio=0.5)
    _, _, state, step, _ = setup_training(cfg, 2, device="cpu")
    init = state.state_dict()
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    live = state.state_dict()
    assert all(not torch.equal(v, init["classifier"][n])
               for n, v in live["classifier"].items())
    batch = {"feat": torch.randn(B, T, 60), "label": torch.arange(B) % 2,
             "channel": torch.arange(B) % 3}
    m = step(state, batch, 7, adv_gate=1.0)
    assert {"adv_loss", "adv_acc", "clf_loss", "clf_acc"} <= set(m)
    assert all(np.isfinite(float(v)) for v in m.values())
    np.testing.assert_allclose(float(m["total_loss"]),
                               float(m["ang_iso"] + m["adv_loss"]),
                               rtol=1e-6)


def _fast_jax_init(monkeypatch):
    """The JAX loop's ``create_train_state`` jitted (its eager init of
    ResNet18 takes 20 s on the CPU); the same state."""
    orig = jloop.create_train_state

    def jitted(rng, model, example, **kw):
        return jax.jit(lambda r: orig(r, model, example, **kw))(rng)

    monkeypatch.setattr(jloop, "create_train_state", jitted)


def test_generate_score_cli_resnet_isolate_matches_jax_cli(tmp_path,
                                                           monkeypatch):
    """A port ResNet18 + isolate run folder, scored by the port's CLI with
    ``-l isolate`` on the CPU, against the JAX CLI over a JAX run folder of
    the same weights and center (atol 1e-4): the distance to the center."""
    paths = feature_trees(tmp_path / "feats")
    monkeypatch.setattr(jscoring, "make_score_fn", shared_jax_make_score_fn)
    _fast_jax_init(monkeypatch)
    variables = random_flax_variables(5, model="resnet", enc_dim=ENC)
    center = np.random.default_rng(6).standard_normal((1, ENC)).astype(
        np.float32)
    common = dict(model="resnet", add_loss="isolate", enc_dim=ENC,
                  feat_len=50)
    port = str(tmp_path / "runs" / "port")
    cfg = TrainConfig(out_fold=port, **common)
    state = setup_training(cfg, 1, device="cpu")[2]
    state.model.load_state_dict(from_flax_variables(variables,
                                                    model="resnet"))
    with torch.no_grad():
        state.loss_module.center.copy_(torch.from_numpy(center))
    os.makedirs(port)
    with open(os.path.join(port, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    save_checkpoint(os.path.join(port, "best.pt"), state)

    jrun = str(tmp_path / "runs" / "jax")
    jcfg = jloop.TrainConfig(out_fold=jrun, **common)
    jst = jloop.setup_training(jcfg, steps_per_epoch=1)[2]
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    jv = port_resnet(sd)
    jst = jst.replace(params=jv["params"], batch_stats=jv["batch_stats"],
                      loss_params={"center": center})
    os.makedirs(jrun)
    with open(os.path.join(jrun, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(jcfg), f)
    j_save_checkpoint(os.path.join(jrun, "best"), jst)

    monkeypatch.chdir(tmp_path)
    args = ["--model_folder", str(tmp_path / "runs"), "-t", "19dev",
            "--batch_size", "4", "--ori_features", paths["ori_features"],
            "-l", "isolate"]
    j_cli.main(["-n", "jax", *args])
    got = p_cli.main(["-n", "port", "--device", "cpu", *args])
    assert_same_score_files(got, tmp_path / "scores" / "jax_19dev_score.txt",
                            6)



def test_jax_lcnn_p2sgrad_run_through_the_converter(tmp_path, monkeypatch):
    """A JAX LCNN + p2sgrad run (feat_len 48), converted by
    ``tools/jax_checkpoint_to_torch.py``: the port's run folder keeps the
    family, the loss and feat_len; its checkpoint holds the model (the
    head's rows permuted to the NCHW flatten), P2SGrad's weight and the
    step; ``cli.generate_score``'s loader rebuilds the system, and its
    eval-mode LCNN scores as the JAX model does (1e-4 of the largest)."""
    import importlib.util

    from asvspoof2021_air_tpu_torch.scoring import make_score_fn

    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                     "jax_checkpoint_to_torch.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    _fast_jax_init(monkeypatch)
    T = FRAMES["lcnn"]
    cfg = jloop.TrainConfig(out_fold=str(tmp_path / "jax"), model="lcnn",
                            add_loss="p2sgrad", enc_dim=ENC, feat_len=T)
    state = jloop.setup_training(cfg, steps_per_epoch=1)[2]
    tree = random_flax_variables(9, model="lcnn", enc_dim=ENC, feat_len=T)
    weight = np.random.default_rng(10).uniform(0, 2, (ENC, 2)).astype(
        np.float32)
    state = state.replace(params=tree["params"],
                          batch_stats=tree["batch_stats"],
                          loss_params={"weight": weight}, step=3)
    os.makedirs(tmp_path / "jax")
    with open(tmp_path / "jax" / "args.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    j_save_checkpoint(str(tmp_path / "jax" / "best"), state)
    converter.main(["--model_dir", str(tmp_path / "jax"), "--out",
                    str(tmp_path / "port")])
    args = json.load(open(tmp_path / "port" / "args.json"))
    assert (args["model"], args["add_loss"], args["feat_len"]) == (
        "lcnn", "p2sgrad", T)
    sd, loss_mod, pcfg = p_cli.load_system(str(tmp_path / "port"),
                                           device="cpu")
    want = from_flax_variables(tree, model="lcnn")
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    assert torch.equal(loss_mod.weight.detach(), torch.from_numpy(weight))
    x = np.random.default_rng(11).standard_normal((B, T, 60)).astype(
        np.float32)
    emb, logits = jax_model("lcnn", T).apply(tree, jnp.asarray(x), False)
    jloss = j_build_loss("p2sgrad", enc_dim=ENC)
    want_score = jscoring.score_rule(
        "p2sgrad", emb, logits, jloss,
        {"params": {"weight": jnp.asarray(weight)}})
    got = make_score_fn(sd, loss_mod, "p2sgrad", model="lcnn",
                        device="cpu")(x)
    assert float(np.abs(got.numpy() - np.asarray(want_score)).max()) <= \
        1e-4 * float(np.abs(np.asarray(want_score)).max())
