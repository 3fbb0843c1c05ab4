"""The port's losses and optimizers against the JAX package, on the CPU:
the train step's cross-entropy and BCE (values and gradients),
OC-Softmax's gradients in the embedding and the center, the step-decay
schedule, Adam with coupled L2 on the backbone and plain SGD on the
center (the dual optimizer of train/state.py), and the host prefetch
thread."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.losses.basic import (
    binary_cross_entropy_with_logits as j_bce)
from asvspoof2021_air_tpu.losses.basic import cross_entropy as j_ce
from asvspoof2021_air_tpu.losses.one_class import OCSoftmax as JOCSoftmax
from asvspoof2021_air_tpu.train import state as jstate
from asvspoof2021_air_tpu_torch.data.prefetch import PrefetchIterator
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import base_loss_and_score


@pytest.mark.parametrize("kind", ["ce", "bce"])
def test_base_losses_and_gradients_match_jax(kind):
    """The train step's base loss (torch's CE, or BCE-with-logits on the
    first logit) against the JAX package's losses/basic.py."""
    g = np.random.default_rng(0)
    logits = (3 * g.standard_normal((16, 2))).astype(np.float32)
    labels = (g.random(16) < 0.5).astype(np.int32)
    if kind == "ce":
        jfn = lambda lg: j_ce(lg, jnp.asarray(labels))
    else:
        jfn = lambda lg: j_bce(lg[:, 0], jnp.asarray(labels))
    tfn = lambda lg: base_loss_and_score(kind, lg,
                                         torch.from_numpy(labels).long())[0]
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = tfn(t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)


def test_ocsoftmax_gradients_match_jax():
    """d loss / d embedding and d loss / d center, 1e-5: the center's
    gradient is what its SGD step follows."""
    g = np.random.default_rng(1)
    center = g.uniform(-2, 2, (1, 24)).astype(np.float32)
    emb = g.standard_normal((12, 24)).astype(np.float32)
    labels = (np.arange(12) % 2).astype(np.int32)
    jmod = JOCSoftmax(feat_dim=24, r_real=0.9, r_fake=0.2, alpha=20.0)
    jfn = lambda c, e: jmod.apply({"params": {"center": c}}, e,
                                  jnp.asarray(labels))[0]
    want_c, want_e = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(center),
                                                   jnp.asarray(emb))
    port = OCSoftmax(feat_dim=24, r_real=0.9, r_fake=0.2, alpha=20.0,
                     device="cpu")
    with torch.no_grad():
        port.center.copy_(torch.from_numpy(center))
    te = torch.from_numpy(emb).requires_grad_()
    port(te, torch.from_numpy(labels))[0].backward()
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_e),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.center.grad.numpy(), np.asarray(want_c),
                               rtol=1e-5, atol=1e-7)


def test_step_decay_schedule_matches_jax():
    want = jstate.step_decay_schedule(5e-4, 0.5, 3, 7)
    got = step_decay_schedule(5e-4, 0.5, 3, 7)
    for step in (0, 6, 7, 20, 21, 41, 42, 100, 1000):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-12)


def test_dual_optimizer_matches_optax():
    """Five steps of the port's TrainState (Adam with coupled L2 on the
    backbone, SGD on the center) against make_backbone_optimizer and
    make_loss_optimizer, through a schedule that halves every two steps,
    on the same gradients: within 1e-6 absolute, 1e-4 of one step, since
    the two take Adam's bias corrections in other orders. One backbone
    tensor gets no gradient (None in torch, zeros in JAX), and weight
    decay still moves it in both."""
    g = np.random.default_rng(2)
    sched_args = (1e-2, 0.5, 1, 2)
    backbone = torch.nn.Linear(5, 3)
    center = OCSoftmax(feat_dim=4, device="cpu")
    state = create_train_state(backbone, center,
                               step_decay_schedule(*sched_args))
    params = {"w": backbone.weight.detach().numpy().copy(),
              "b": backbone.bias.detach().numpy().copy()}
    lparams = {"center": center.center.detach().numpy().copy()}
    jsched = jstate.step_decay_schedule(*sched_args)
    btx = jstate.make_backbone_optimizer(jsched)
    ltx = jstate.make_loss_optimizer(jsched)
    bopt, lopt = btx.init(params), ltx.init(lparams)
    for _ in range(5):
        gw = g.standard_normal((3, 5)).astype(np.float32)
        gc = g.standard_normal((1, 4)).astype(np.float32)
        grads = {"w": gw, "b": np.zeros(3, np.float32)}
        upd, bopt = btx.update(grads, bopt, params)
        params = optax.apply_updates(params, upd)
        lupd, lopt = ltx.update({"center": gc}, lopt, lparams)
        lparams = optax.apply_updates(lparams, lupd)

        state.zero_grad()
        backbone.weight.grad = torch.from_numpy(gw)
        center.center.grad = torch.from_numpy(gc)
        state.apply_gradients()
    assert state.step == 5
    for got, want in ((backbone.weight, params["w"]),
                      (backbone.bias, params["b"]),
                      (center.center, lparams["center"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


def test_prefetch_iterator_yields_in_order_and_reraises():
    class Source:
        steps_per_epoch, batch_size = 5, 2

        def epoch(self):
            yield from range(self.steps_per_epoch)

    it = PrefetchIterator(Source(), depth=2)
    assert (it.steps_per_epoch, it.batch_size) == (5, 2)
    assert list(it.epoch()) == list(range(5))
    assert list(it) == list(range(5))

    def broken():
        yield 1
        raise OSError("unreadable wav")

    with pytest.raises(OSError, match="unreadable"):
        list(PrefetchIterator(broken()).epoch())
