"""The port's train-mode Res2 chain (``ops/res2_chain_vjp.py``), ECAPA's
``fused_chain`` and the ``remat_policy="conv_dot"`` step, against the JAX
package's, on the CPU.

Bars: the op's forward and BN batch statistics within rtol 2e-5 / atol
2e-5 of JAX's ``res2_chain_train``, its gradients (input, kernels, conv
biases, BN scales and biases; cotangents on the output and on the
statistics) within rtol 5e-4 / atol 5e-4: the bars of
``tests/test_res2_chain_vjp.py``. The port's fused chain against its own
unfused chain: forward and running statistics bitwise (the forward is the
same ops), gradients within rtol 5e-4 / atol 5e-4, eval mode bitwise
unchanged. ECAPA with ``fused_chain`` in train mode against the JAX model
with ``fused_chain`` at ``test_ecapa_train_mode_matches_jax``'s bars. The
``conv_dot`` step against the port's step without it: bitwise on the CPU
(the recompute repeats the forward's ops in the same order) over two
steps; and a 4-step ``conv_dot`` (and ``fused_chain``) trajectory against
JAX's at the f32 trajectory bars of ``tests/test_torch_train.py``. The
fused chain inside a data-parallel BN group (2 gloo ranks) against the
one-process step at ``tests/test_torch_parallel.py``'s bars, and
``conv_dot`` through ``make_multi_step`` at K = 2 against two single
steps, bitwise."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.ops.res2_chain_vjp import (
    res2_chain_train as j_res2_chain_train)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables)
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.models.ecapa import Bottle2neck
from asvspoof2021_air_tpu_torch.ops.res2_chain_vjp import res2_chain_train
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import (
    StepConfig, make_multi_step, make_train_step)
import torch_parallel_workers as W
from test_torch_parallel import assert_step_matches
from test_torch_train import (
    B, ENC, SCALE, T, _jmodel, _params_only, _port_model,
    check_ecapa_trajectory, ecapa_trajectory)
from torch_threads import one_thread  # noqa: F401

G, W_, D = 7, 8, 2          # scale 8 over 64 channels, dilation 2


def _op_inputs(seed: int = 0):
    g = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * g.standard_normal(s)).astype(
        np.float32)
    x = f(4, 50, (G + 1) * W_)
    Wj = f(G, 3, W_, W_, scale=1 / np.sqrt(3 * W_))      # (tap, in, out)
    CB, S, Bb = f(G, W_, scale=0.1), 1 + f(G, W_, scale=0.1), f(
        G, W_, scale=0.1)
    cot = (f(*x.shape), f(G, W_, scale=0.3), f(G, W_, scale=0.3))
    return x, Wj, CB, S, Bb, cot


def test_op_forward_statistics_and_gradients_match_jax():
    x, Wj, CB, S, Bb, (g_out, g_mu, g_var) = _op_inputs()

    def jloss(x, W, CB, S, Bb):
        out, mu, var = j_res2_chain_train(x, W, CB, S, Bb, D, 1e-5)
        return (jnp.sum(out * g_out) + jnp.sum(mu * g_mu)
                + jnp.sum(var * g_var)), (out, mu, var)

    grads, (out, mu, var) = jax.jit(jax.grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *map(jnp.asarray, (x, Wj, CB, S, Bb)))
    tx = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    tW = torch.from_numpy(Wj.transpose(0, 3, 2, 1).copy()).requires_grad_()
    tCB, tS, tBb = (torch.from_numpy(a).requires_grad_()
                    for a in (CB, S, Bb))
    pout, pmu, pvar = res2_chain_train(tx, tW, tCB, tS, tBb, D, 1e-5)
    torch.autograd.backward(
        (pout, pmu, pvar),
        (torch.from_numpy(g_out.transpose(0, 2, 1).copy()),
         torch.from_numpy(g_mu), torch.from_numpy(g_var)))
    fwd = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pout.detach().numpy().transpose(0, 2, 1),
                               np.asarray(out), **fwd)
    np.testing.assert_allclose(pmu.detach().numpy(), np.asarray(mu), **fwd)
    np.testing.assert_allclose(pvar.detach().numpy(), np.asarray(var), **fwd)
    bwd = dict(rtol=5e-4, atol=5e-4)
    for name, got, want in (
            ("x", tx.grad.numpy().transpose(0, 2, 1), grads[0]),
            ("W", tW.grad.numpy().transpose(0, 3, 2, 1), grads[1]),
            ("CB", tCB.grad.numpy(), grads[2]),
            ("S", tS.grad.numpy(), grads[3]),
            ("Bb", tBb.grad.numpy(), grads[4])):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name,
                                   **bwd)


def _blocks(seed: int = 1):
    torch.manual_seed(seed)
    plain = Bottle2neck(64, 3, D, 8)
    fused = Bottle2neck(64, 3, D, 8, fused_chain=True)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(4, 64, 50)
    return plain, fused, x


def test_fused_block_equals_the_unfused_block():
    """Forward and running statistics bitwise, gradients of a mixed loss
    within rtol 5e-4 / atol 5e-4 (the input's too); the variable names the
    same (one state_dict serves both)."""
    plain, fused, x = _blocks()
    mix = torch.sin(torch.arange(x.numel(), dtype=torch.float32)
                    .reshape(x.shape) * 1e-3)
    outs = []
    for m in (plain, fused):
        xx = x.clone().requires_grad_()
        out = m.train()(xx)
        (out * mix).sum().backward()
        outs.append((out.detach(), xx.grad, dict(m.named_parameters())))
    assert torch.equal(outs[0][0], outs[1][0])
    for (k, a), b in zip(plain.state_dict().items(),
                         fused.state_dict().values()):
        assert torch.equal(a, b), k
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=5e-4, atol=5e-4)
    for n, p in outs[0][2].items():
        np.testing.assert_allclose(outs[1][2][n].grad, p.grad, rtol=5e-4,
                                   atol=5e-4, err_msg=n)


def test_eval_path_unchanged():
    plain, fused, x = _blocks(2)
    with torch.no_grad():
        assert torch.equal(plain.eval()(x), fused.eval()(x))


def test_fused_chain_refused_under_a_data_parallel_group(tmp_path):
    """``fused_chain`` is no longer refused inside a data-parallel BN
    group: one ECAPA ang_iso step with ``fused_chain`` on 2 gloo ranks of
    8 rows (``tests/torch_parallel_workers.run_fused_chain``) against the
    one-process step on the global 16, at
    ``tests/test_torch_parallel.py``'s bars (``assert_step_matches``:
    metrics rtol 1e-6, each all-reduced gradient's error norm within
    max(1e-5, 4 x the one-process step's own spread with the batch
    reversed) of its norm, BN statistics 1e-5 of each tensor's largest
    value past 1); the chain's statistics are the global batch's."""
    start = W.fused_chain_state().state_dict()
    batch = W.feature_batches(1, seed=5)[0]
    ranks = W.Ranks("run_fused_chain", 2, str(tmp_path), start=start,
                    batch=batch)
    out = []
    for rows in (slice(None), slice(None, None, -1)):
        st = W.fused_chain_state(start)
        step = make_train_step(StepConfig(add_loss="ang_iso"), device="cpu")
        m = step(st, W.tensors({k: np.ascontiguousarray(v[rows])
                                for k, v in batch.items()}))
        out.append((W.host(m), W.host(W.grads(st)), W.host(W.running(st))))
    (metrics, grads, running), (_, rev, _) = out
    spread = {n: np.linalg.norm(rev[n] - g) / max(np.linalg.norm(g), 1e-30)
              for n, g in grads.items()}
    for r in ranks.join(120):
        assert_step_matches(r, metrics, grads, running, spread,
                            "fused_chain data parallel")


def test_ecapa_fused_chain_train_mode_matches_jax():
    """The port's ECAPA with ``fused_chain`` against the JAX model with
    ``fused_chain``: embedding and logits 5e-4, batch statistics rtol 1e-4
    / atol 1e-5, gradients rtol 5e-3 / atol 2e-4 max(1, largest)."""
    feats = np.random.default_rng(11).standard_normal((B, T, 60)).astype(
        np.float32)
    model = _jmodel(fused_chain=True)
    v = jax.tree.map(np.asarray, model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(feats), False))

    @jax.jit
    def fwd_grad(params):
        def loss(p):
            (e, lg), mut = model.apply(
                {"params": p, "batch_stats": v["batch_stats"]},
                jnp.asarray(feats), True, mutable=["batch_stats"])
            return jnp.sum(e ** 2) + jnp.sum(lg ** 2), (e, lg, mut)
        return jax.grad(loss, has_aux=True)(params)

    grads, (emb, logits, mut) = fwd_grad(v["params"])
    port = _port_model(fused_chain=True).train()
    port.load_state_dict(from_flax_variables(v, SCALE))
    pe, pl = port(torch.from_numpy(feats))
    (pe.pow(2).sum() + pl.pow(2).sum()).backward()
    for got, want in ((pe, emb), (pl, logits)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4)
    want_sd = from_flax_variables(jax.tree.map(np.asarray, {
        "params": v["params"], "batch_stats": mut["batch_stats"]}), SCALE)
    got_sd = port.state_dict()
    for k in want_sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    want_g = _params_only(from_flax_variables(jax.tree.map(np.asarray, {
        "params": grads, "batch_stats": v["batch_stats"]}), SCALE))
    for n, p in port.named_parameters():
        w = want_g[n].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=5e-3,
            atol=2e-4 * max(1.0, float(np.abs(w).max())), err_msg=n)


def _port_steps(remat_policy, fused_chain: bool = False, n: int = 2):
    torch.manual_seed(0)
    st = create_train_state(
        _port_model(fused_chain),
        OCSoftmax(feat_dim=ENC, device="cpu"),
        step_decay_schedule(5e-4, 0.5, 1, 2))
    step = make_train_step(StepConfig(add_loss="ang_iso",
                                      remat_policy=remat_policy),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    metrics = [step(st, {"feat": torch.randn(B, T, 60, generator=g),
                         "label": torch.arange(B) % 2}) for _ in range(n)]
    return st.state_dict(), metrics


@pytest.mark.parametrize("fused_chain", [False, True])
def test_conv_dot_step_equals_the_plain_step(fused_chain):
    """Two ``conv_dot`` steps against two plain ones from the same state:
    metrics, parameters, BN running statistics (restored after the
    recompute's second update) and Adam moments bitwise on the CPU."""
    want_sd, want_m = _port_steps(None, fused_chain)
    got_sd, got_m = _port_steps("conv_dot", fused_chain)
    for a, b in zip(got_m, want_m):
        assert {k: float(v) for k, v in a.items()} == {
            k: float(v) for k, v in b.items()}
    for part in ("model", "loss_module"):
        for k, v in want_sd[part].items():
            assert torch.equal(got_sd[part][k], v), (part, k)
    for k, v in want_sd["optimizer"].items():
        for name, t in v.items():
            assert torch.equal(got_sd["optimizer"][k][name], t), (k, name)


def test_conv_dot_recomputes_and_other_policies_raise():
    """The checkpoint does recompute (each block's forward runs twice in
    a ``conv_dot`` step), a policy other than ``conv_dot`` raises
    ValueError as the JAX step does, and ``make_multi_step`` runs the
    policy at K = 2 (on the CPU a loop; on the card the K-step graph
    captures it, ``chip_smoke.py`` phase 9b): its two steps against two
    single ``conv_dot`` steps from the same state, metrics and every
    tensor of the state bitwise."""
    calls = {"n": 0}
    st = create_train_state(_port_model(), OCSoftmax(feat_dim=ENC,
                                                     device="cpu"),
                            step_decay_schedule(5e-4, 0.5, 1, 2))
    st.model.layer2.register_forward_hook(
        lambda *a: calls.__setitem__("n", calls["n"] + 1))
    step = make_train_step(StepConfig(add_loss="ang_iso",
                                      remat_policy="conv_dot"), device="cpu")
    step(st, {"feat": torch.randn(B, T, 60), "label": torch.arange(B) % 2})
    assert calls["n"] == 2
    with pytest.raises(ValueError, match="full"):
        make_train_step(StepConfig(remat_policy="full"), device="cpu")
    g = torch.Generator().manual_seed(3)
    batches = {"feat": torch.randn(2, B, T, 60, generator=g),
               "label": torch.stack([torch.arange(B) % 2] * 2)}
    start = copy.deepcopy(st.state_dict())
    multi = make_multi_step(step, 2)
    m_multi = multi(st, batches)
    after_multi = copy.deepcopy(st.state_dict())
    st.load_state_dict(start)
    m_single = [step(st, {k: v[i] for k, v in batches.items()})
                for i in range(2)]
    after_single = st.state_dict()
    assert after_multi["step"] == after_single["step"] == start["step"] + 2
    for k in m_multi:
        assert torch.equal(m_multi[k], torch.stack([m[k] for m in
                                                    m_single])), k
    for part in ("model", "loss_module"):
        for k, v in after_single[part].items():
            assert torch.equal(after_multi[part][k], v), (part, k)
    for k, v in after_single["optimizer"].items():
        for name, t in v.items():
            assert torch.equal(after_multi["optimizer"][k][name], t), k


@pytest.mark.parametrize("remat_policy,fused_chain", [
    ("conv_dot", False), (None, True)], ids=["conv_dot", "fused_chain"])
def test_trajectory_with_remat_or_fused_chain_tracks_jax(remat_policy,
                                                         fused_chain):
    """4 steps with the JAX step's ``remat_policy="conv_dot"`` (or its
    model's ``fused_chain``) on both sides, from one mid-training state:
    the bars of the plain f32 trajectory."""
    check_ecapa_trajectory(ecapa_trajectory(remat_policy, fused_chain))
