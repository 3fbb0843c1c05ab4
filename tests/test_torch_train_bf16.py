"""bf16 compute in the port's ECAPA against the JAX package's
``ECAPA_TDNN(dtype=bfloat16, fused_pool=True, fused_bn=True)`` on the CPU,
at small shapes: the model in train and eval mode (embeddings, logits, BN
statistics, every gradient) and a 4-step ang_iso trajectory.

The JAX model runs its Pallas VJP in interpret mode. Two bf16 runs of one
function differ wherever a sum taken in another order rounds to another
bf16 value, so the bar for each quantity is the distance between JAX's own
bf16 and f32 results, measured in the same test, or 1e-2 of the norm,
whichever is larger."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.losses import build_loss
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.train import state as jstate
from asvspoof2021_air_tpu.train.steps import StepConfig as JStepConfig
from asvspoof2021_air_tpu.train.steps import make_train_step as j_make_step
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_train_state, from_flax_variables)
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.models.common import Logistic
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.train.state import (
    create_train_state, step_decay_schedule)
from asvspoof2021_air_tpu_torch.train.steps import StepConfig, make_train_step

from torch_threads import one_thread  # noqa: F401

# The shapes of tests/test_torch_train.py: C=32, scale 4, embedding 16,
# batch 8 (train-mode BN), 40 frames.
C, SCALE, ENC, B, T = 32, 4, 16, 8, 40
LR = 5e-4
BF16 = torch.bfloat16

disable_tf32()


def _jmodel(dtype, fused: bool = True):
    """The JAX model with fused_pool and fused_bn both ``fused``."""
    return JECAPA(C=C, model_scale=SCALE, n_out=2, n_feat=60, enc_dim=ENC,
                  fused_pool=fused, pool_interpret=fused, fused_bn=fused,
                  dtype=dtype)


def _rel(a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_logistic_is_lax_logistic():
    """``Logistic`` against ``jax.nn.sigmoid`` in bf16, bitwise, forward
    and backward (XLA computes it as 1 / (1 + exp(-x)) op by op, and
    ``lax.logistic``'s rule g y (1 - y)); in f32 against
    ``torch.sigmoid``, 1e-6."""
    g = np.random.default_rng(0)
    x = (4 * g.standard_normal(4096)).astype(np.float32)
    gy = g.standard_normal(4096).astype(np.float32)
    jy, pull = jax.vjp(jax.nn.sigmoid, jnp.asarray(x, jnp.bfloat16))
    (jdx,) = pull(jnp.asarray(gy, jnp.bfloat16))
    tx = torch.from_numpy(x).to(BF16).requires_grad_()
    ty = Logistic.apply(tx)
    ty.backward(torch.from_numpy(gy).to(BF16))
    assert ty.dtype == tx.grad.dtype == BF16
    assert np.array_equal(ty.detach().float().numpy(),
                          np.asarray(jy, np.float32))
    assert np.array_equal(tx.grad.float().numpy(), np.asarray(jdx, np.float32))
    t32 = torch.from_numpy(x)
    torch.testing.assert_close(Logistic.apply(t32), torch.sigmoid(t32),
                               rtol=1e-6, atol=1e-6)


def test_compute_dtype_needs_fused_pool(monkeypatch):
    """A bf16 model no longer needs ``fused_pool``: with fused_pool=False
    it builds, and its train and eval forwards pool without
    FusedSoftmaxStats (the JAX model's unfused tail in bf16; its values
    against JAX are tests/test_torch_unfused.py's), returning f32. A
    compute dtype other than bf16 is still refused."""
    import asvspoof2021_air_tpu_torch.models.ecapa as ecapa_mod

    def refused(*a, **k):
        raise AssertionError("fused_pool=False reached FusedSoftmaxStats")

    monkeypatch.setattr(ecapa_mod, "fused_softmax_stats", refused)
    model = ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, dtype=BF16,
                       fused_pool=False, device="cpu")
    x = torch.randn(B, T, 60, generator=torch.Generator().manual_seed(0))
    for train in (True, False):
        emb, logits = model.train(train)(x)
        assert emb.dtype == logits.dtype == torch.float32
        assert emb.shape == (B, ENC) and bool(torch.isfinite(emb).all())
    with pytest.raises(ValueError, match="dtype"):
        ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, fused_pool=True,
                   dtype=torch.float16, device="cpu")


@pytest.mark.parametrize("train", [True, False])
def test_bf16_ecapa_matches_jax(train):
    """Embeddings, logits, the updated BN statistics and the gradient of
    every parameter (of sum emb^2 + sum logits^2): port bf16 against JAX
    bf16 within max(|JAX bf16 - JAX f32|, 1e-2) in norm, relative. A
    gradient may instead be as close to JAX's f32 one as that bar: XLA's
    CPU backend sums a bf16 bias cotangent over (B, T) in bf16 (1.7e-2 off
    the exact sum on (8, 40, 64) bf16 values, where torch's f32
    accumulation is 1.8e-3 off), so the two bf16 runs part there by both
    errors. Measured, eval mode: layer1.convs.1.bias, 1.51e-2 from JAX
    bf16 and 1.01e-2 from JAX f32 (9.98e-3 when this check was written),
    past its bar of 1e-2, where JAX bf16 is 8.2e-3 from f32 and JAX's own
    bf16 cotangent, summed exactly, lands 1.08e-2 from JAX f32 and 1.64e-2
    from JAX bf16 (``tools/jax_bf16_bias_noise.py``); every other
    gradient in either mode under 0.91 of its bar. Embeddings
    also have cosine >= 0.9996 to JAX's bf16 ones (the JAX package's bf16
    bar, ``docs/PERFORMANCE.md:45-47``); parameters stay f32 and outputs
    come out f32."""
    check_bf16_ecapa(train)


def check_bf16_ecapa(train: bool, fused: bool = True,
                     noise: tuple = ()) -> None:
    """The checks of ``test_bf16_ecapa_matches_jax`` with fused_pool and
    fused_bn both ``fused`` in each package. A parameter in ``noise``,
    whose gradient is zero in exact arithmetic and rounding noise in
    either package, is held instead under 1e-2 of the largest gradient
    element of JAX's bf16 run, in both packages."""
    feats = np.random.default_rng(11).standard_normal((B, T, 60)).astype(
        np.float32)
    v = jax.tree.map(np.asarray, _jmodel(None).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(feats), False))

    def run(dtype):
        model = _jmodel(dtype, fused)

        def loss(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": v["batch_stats"]},
                jnp.asarray(feats), train, mutable=["batch_stats"])
            return jnp.sum(out[0] ** 2) + jnp.sum(out[1] ** 2), (out, mut)

        g, ((e, lg), mut) = jax.jit(jax.grad(loss, has_aux=True))(
            v["params"])
        to_sd = lambda p, s: from_flax_variables(jax.tree.map(
            np.asarray, {"params": p, "batch_stats": s}), SCALE)
        return (np.asarray(e), np.asarray(lg),
                to_sd(v["params"], mut["batch_stats"]),
                to_sd(g, v["batch_stats"]))

    e32, l32, s32, g32 = run(None)
    eb, lb, sb, gb = run(jnp.bfloat16)
    port = ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, fused_pool=fused,
                      fused_bn=fused, dtype=BF16, device="cpu").train(train)
    port.load_state_dict(from_flax_variables(v, SCALE))
    pe, pl = port(torch.from_numpy(feats))
    (pe.pow(2).sum() + pl.pow(2).sum()).backward()

    assert pe.dtype == pl.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    for name, got, want, ref in (("embedding", pe, eb, e32),
                                 ("logits", pl, lb, l32)):
        got = got.detach().numpy()
        assert _rel(got, want) <= max(_rel(want, ref), 1e-2), name
    cos = torch.nn.functional.cosine_similarity(
        pe.detach(), torch.from_numpy(np.array(eb)), dim=1)
    assert torch.all(cos >= 0.9996), cos
    sd = port.state_dict()
    stats = [k for k in sb if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        assert _rel(sd[k], sb[k]) <= max(_rel(sb[k], s32[k]), 1e-2), k
    checked = 0
    top = max(float(g.abs().max()) for g in gb.values())
    for n, p in port.named_parameters():
        if n in noise:
            assert max(float(p.grad.abs().max()),
                       float(gb[n].abs().max())) <= 1e-2 * top, n
            continue
        if not np.abs(gb[n].numpy()).any():
            continue
        assert p.grad.dtype == torch.float32
        bar = max(_rel(gb[n], g32[n]), 1e-2)
        assert (_rel(p.grad, gb[n]) <= bar
                or _rel(p.grad, g32[n]) <= bar), n
        checked += 1
    assert checked >= 90


WARM, K = 2, 4


@pytest.fixture(scope="module")
def trajectory():
    """The bf16 version of tests/test_torch_train.py's trajectory: WARM
    JAX bf16 steps from init, the state carried across, then K steps in
    each package on the same batches, the learning rate halving every 2
    steps; then the K steps again in each package from the same state on
    every batch with its rows reversed, the same steps in exact
    arithmetic."""
    g = np.random.default_rng(0)
    labels = (np.arange(B) % 2).astype(np.int32)
    feats = g.standard_normal((WARM + K, B, T, 60)).astype(np.float32)
    feats += 0.5 * labels[None, :, None, None]
    model = _jmodel(jnp.bfloat16)
    loss_mod = build_loss("ang_iso", enc_dim=ENC, r_real=0.9, r_fake=0.2,
                          alpha=20.0)
    sched = jstate.step_decay_schedule(LR, 0.5, 1, 2)
    btx = jstate.make_backbone_optimizer(sched)
    ltx = jstate.make_loss_optimizer(sched)
    state = jstate.create_train_state(
        jax.random.PRNGKey(0), model, jnp.asarray(feats[0]),
        loss_module=loss_mod, example_feat=jnp.zeros((B, ENC)),
        example_labels=jnp.asarray(labels), backbone_tx=btx, loss_tx=ltx)
    step = jax.jit(j_make_step(model, loss_mod, btx, ltx,
                               JStepConfig(add_loss="ang_iso")))
    batch = lambda s: {"feat": jnp.asarray(feats[s]),
                       "label": jnp.asarray(labels)}
    key = jax.random.PRNGKey(1)
    for s in range(WARM):
        state, _ = step(state, batch(s), key)
    start = from_flax_train_state(jax.device_get(state), SCALE)
    mid = state
    runs = {}
    for rows in (slice(None), slice(None, None, -1)):
        state, j_losses = mid, []
        for s in range(WARM, WARM + K):
            state, metrics = step(state, {
                "feat": jnp.asarray(feats[s][rows]),
                "label": jnp.asarray(labels[rows])}, key)
            j_losses.append(float(metrics["ang_iso"]))
        pstate = create_train_state(
            ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, fused_pool=True,
                       dtype=BF16, device="cpu"),
            OCSoftmax(feat_dim=ENC, r_real=0.9, r_fake=0.2, alpha=20.0,
                      device="cpu"),
            step_decay_schedule(LR, 0.5, 1, 2))
        pstate.load_state_dict(start)
        pstep = make_train_step(StepConfig(add_loss="ang_iso"),
                                device="cpu")
        p_losses = []
        for s in range(WARM, WARM + K):
            m = pstep(pstate, {
                "feat": torch.from_numpy(feats[s][rows].copy()),
                "label": torch.from_numpy(labels[rows].copy())})
            p_losses.append(float(m["ang_iso"]))
        runs[rows.step] = dict(
            end=from_flax_train_state(jax.device_get(state), SCALE),
            got=pstate.state_dict(), j_losses=np.array(j_losses),
            p_losses=np.array(p_losses))
    out = runs[None]
    out["rev_end"] = runs[-1]["end"]["model"]
    out["rev_got"] = runs[-1]["got"]["model"]
    return out


def test_bf16_trajectory_tracks_jax(trajectory):
    """Losses rtol 2e-2, params within 2 lr K (Adam turns gradient
    differences into steps of up to lr), BN running statistics atol 2e-2
    and the center atol 5e-3. The bars first aimed at were 1e-2 (losses)
    and 5e-3 (statistics); in bf16 the third step's loss is 1.39e-2 from
    JAX's (0.546687 against 0.539187), and three statistics pass 5e-3:
    attention.2.running_mean by 1.05e-2, bn7.running_var by 6.2e-3,
    bn5.running_var by 5.9e-3; that is the size of the train-mode bf16
    embeddings' own distance from JAX's (1.6e-2,
    ``test_bf16_ecapa_matches_jax``). The largest parameter difference is
    9.3e-4 (attention.2.bias), the center's 1.1e-6.

    A statistic's bar is max(2e-2, 4 (s_jax + s_port)), s being each
    package's own spread: the statistic's change when the K steps run
    again on every batch with its rows reversed. On one host
    bn5.running_var read 2.46e-2 from JAX's against the old 2e-2: the
    sums' rounding order is the CPU's, not the code's."""
    t = trajectory
    np.testing.assert_allclose(t["p_losses"], t["j_losses"], rtol=2e-2)
    assert t["got"]["step"] == t["end"]["step"] == WARM + K
    want, got = t["end"]["model"], t["got"]["model"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = 2 * LR * K
        if k.endswith(("running_mean", "running_var")):
            s_jax = float((t["rev_end"][k] - w).abs().max())
            s_port = float((t["rev_got"][k] - got[k]).abs().max())
            atol = max(2e-2, 4 * (s_jax + s_port))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(t["got"]["loss_module"]["center"].numpy(),
                               t["end"]["loss_module"]["center"].numpy(),
                               atol=5e-3)
