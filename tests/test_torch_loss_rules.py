"""The port's one-class losses and scoring rules against the JAX package, on
the CPU: Isolate, IsolateSquare, P2SGrad and AMSoftmax (values, gradients
in the embedding and in the loss's parameters, 1e-5), the base losses'
focal loss and center loss, the add-loss registry, and ``score_rule`` for
every rule the JAX scorer has (1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.losses import basic as jbasic
from asvspoof2021_air_tpu.losses import one_class as joc
from asvspoof2021_air_tpu.losses.registry import build_loss as j_build_loss
from asvspoof2021_air_tpu.scoring import score_rule as j_score_rule
from asvspoof2021_air_tpu_torch.losses import basic, one_class
from asvspoof2021_air_tpu_torch.losses.registry import (
    LOSS_REGISTRY, build_loss)
from asvspoof2021_air_tpu_torch.scoring import score_rule

D, N = 12, 10
TOL = dict(rtol=1e-5, atol=1e-6)


def _data(seed: int, labels=None):
    g = np.random.default_rng(seed)
    emb = g.standard_normal((N, D)).astype(np.float32)
    if labels is None:
        labels = (np.arange(N) % 3 == 0).astype(np.int32)
    return g, emb, np.asarray(labels, np.int32)


def _params(name: str, g):
    """Seeded parameters of the loss named ``name``, flax names."""
    if name in ("isolate", "iso_sq", "ang_iso"):
        return {"center": g.standard_normal((1, D)).astype(np.float32)}
    if name == "p2sgrad":
        return {"weight": (2 * g.random((D, 2))).astype(np.float32)}
    return {"centers": g.standard_normal((2, D)).astype(np.float32)}


def _port(name: str, params, **kw):
    module = build_loss(name, enc_dim=D, device="cpu", **kw)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            params.items()})
    return module


def _scalar(name: str, out, labels):
    """The scalar each loss trains with: the loss itself, or for AMSoftmax
    the cross-entropy of its margin logits."""
    if name == "amsoftmax":
        return out[1], out[0]
    return (out[0], out[1]) if isinstance(out, tuple) else (out, None)


@pytest.mark.parametrize("name,labels", [
    ("isolate", None), ("iso_sq", None), ("p2sgrad", None),
    ("amsoftmax", None), ("isolate", [0] * N), ("iso_sq", [1] * N)])
def test_loss_value_and_gradients_match_jax(name, labels):
    """The loss (AMSoftmax: CE of its margin logits) and its second output
    (the score, or AMSoftmax's cosine logits), and the gradients in the
    embedding and in every parameter of the loss, 1e-5; a batch of one
    class divides the other class's empty sum by one, as JAX does."""
    g, emb, lab = _data(0, labels)
    params = _params(name, g)
    jmod = j_build_loss(name, enc_dim=D)

    def jfn(p, e):
        out = jmod.apply({"params": p}, e, jnp.asarray(lab))
        loss, second = _scalar(name, out, lab)
        if name == "amsoftmax":
            loss = jbasic.cross_entropy(loss, jnp.asarray(lab))
        return loss, second

    (want, want2), (gp, ge) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(emb))
    port = _port(name, params)
    te = torch.from_numpy(emb).requires_grad_()
    loss, second = _scalar(name, port(te, torch.from_numpy(lab)), lab)
    if name == "amsoftmax":
        loss = basic.cross_entropy(loss, torch.from_numpy(lab))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    if second is not None:
        np.testing.assert_allclose(second.detach().numpy(),
                                   np.asarray(want2), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **TOL)
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[k]),
                                   err_msg=k, **TOL)


def test_p2sgrad_label_smoothing_matches_jax():
    """``smooth`` 0.1 (the module's default; the registry builds 0.0)."""
    g, emb, lab = _data(1)
    w = (2 * g.random((D, 2))).astype(np.float32)
    want, _ = joc.P2SGradLoss(in_dim=D, smooth=0.1).apply(
        {"params": {"weight": jnp.asarray(w)}}, jnp.asarray(emb),
        jnp.asarray(lab))
    port = one_class.P2SGradLoss(D, smooth=0.1, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
    got, _ = port(torch.from_numpy(emb), torch.from_numpy(lab))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert build_loss("p2sgrad", enc_dim=D, device="cpu").smooth == 0.0


RULES = [None, "softmax", "ocsoftmax", "ang_iso", "isolate", "iso_sq",
         "p2sgrad", "amsoftmax"]


@pytest.mark.parametrize("rule", RULES)
def test_score_rule_matches_jax(rule):
    """``score_rule`` for every rule of the JAX scorer (None and 'softmax':
    -softmax(logits)[:, 0]; the loss module's score for ocsoftmax, ang_iso
    and p2sgrad; softmax over AMSoftmax's cosine logits; the distance to
    the center for isolate and iso_sq), 1e-5."""
    g, emb, _lab = _data(2)
    logits = g.standard_normal((N, 2)).astype(np.float32)
    loss = None if rule in (None, "softmax") else rule
    name = {"ocsoftmax": "ang_iso"}.get(loss, loss)
    jmod = port = lv = None
    if name is not None:
        params = _params(name, g)
        jmod = j_build_loss(name, enc_dim=D)
        lv = {"params": {k: jnp.asarray(v) for k, v in params.items()}}
        port = _port(name, params)
    want = j_score_rule(loss, jnp.asarray(emb), jnp.asarray(logits), jmod,
                        lv)
    with torch.no_grad():
        got = score_rule(loss, torch.from_numpy(emb),
                         torch.from_numpy(logits), port)
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gamma,alpha,mean", [
    (0.0, None, True), (2.0, 0.25, True), (1.5, [0.3, 0.7], False)])
def test_focal_loss_matches_jax(gamma, alpha, mean):
    g, _e, lab = _data(3)
    logits = (2 * g.standard_normal((N, 2))).astype(np.float32)
    want, want_g = jax.value_and_grad(lambda x: jbasic.focal_loss(
        x, jnp.asarray(lab), gamma, alpha, mean))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = basic.focal_loss(t, torch.from_numpy(lab), gamma, alpha, mean)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), **TOL)


def test_center_loss_matches_jax():
    """Value 0.5 sum ||x - c_y||^2; the feature gradient x - c_y and the
    count-normalized center gradient, as the JAX module's."""
    g, emb, lab = _data(4)
    centers = g.standard_normal((2, D)).astype(np.float32)
    jmod = jbasic.CenterLoss(num_classes=2, feat_dim=D)
    (want, (gc, ge)) = jax.value_and_grad(
        lambda c, e: jmod.apply({"params": {"centers": c}}, e,
                                jnp.asarray(lab)), argnums=(0, 1))(
        jnp.asarray(centers), jnp.asarray(emb))
    port = basic.CenterLoss(2, D, device="cpu")
    with torch.no_grad():
        port.centers.copy_(torch.from_numpy(centers))
    te = torch.from_numpy(emb).requires_grad_()
    got = port(te, torch.from_numpy(lab))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **TOL)
    np.testing.assert_allclose(port.centers.grad.numpy(), np.asarray(gc),
                               **TOL)


def test_registry_builds_the_jax_modules_with_flax_inits():
    """Every name of the JAX registry, the same module kinds and
    hyperparameters; the parameters drawn as flax draws them (the Isolate
    centers and AMSoftmax's from N(0, 1), P2SGrad's weight from U[0, 2));
    None and "None" build nothing; an unknown name is a ValueError."""
    assert set(LOSS_REGISTRY) == {"ang_iso", "ocsoftmax", "isolate",
                                  "iso_sq", "p2sgrad", "amsoftmax"}
    gen = torch.Generator().manual_seed(0)
    kinds = {"ang_iso": one_class.OCSoftmax, "ocsoftmax": one_class.OCSoftmax,
             "isolate": one_class.IsolateLoss,
             "iso_sq": one_class.IsolateSquareLoss,
             "p2sgrad": one_class.P2SGradLoss,
             "amsoftmax": one_class.AMSoftmax}
    for name, kind in kinds.items():
        m = LOSS_REGISTRY[name](enc_dim=256, r_real=0.5, r_fake=0.3,
                                generator=gen, device="cpu")
        assert type(m) is kind, name
        if name in ("isolate", "iso_sq"):
            assert (m.r_real, m.r_fake) == (0.5, 0.3)
            c = m.center.detach()
            assert c.shape == (1, 256) and abs(float(c.std()) - 1) < 0.15
        if name == "p2sgrad":
            w = m.weight.detach()
            assert w.shape == (256, 2) and 0 <= float(w.min())
            assert float(w.max()) < 2 and abs(float(w.mean()) - 1) < 0.1
        if name == "amsoftmax":
            assert m.centers.shape == (2, 256) and (m.s, m.m) == (20.0, 0.9)
    assert build_loss(None) is None and build_loss("None") is None
    with pytest.raises(ValueError, match="unknown"):
        build_loss("center", device="cpu")
