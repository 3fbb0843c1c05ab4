#!/usr/bin/env python3
"""How far the JAX package's own bf16 bias gradient lies from its f32 one
on the CPU, and how much of that is the bf16 sum.

    JAX_PLATFORMS=cpu python3 tools/jax_bf16_bias_noise.py [--train]

At the shapes and seed of ``tests/test_torch_train_bf16.py``'s
``test_bf16_ecapa_matches_jax`` (ECAPA C 32, scale 4, B 8, T 40, loss
sum emb^2 + sum logits^2), takes the gradient of ``layer1.convs.1.bias``
(``Bottle2neck_0/Conv_2``) in f32 and in bf16, and the bf16 cotangent at
that conv's output (through a zero perturbation added to it). Prints the
relative distances (norm) that the test compares with its bar of
max(|bf16 - f32|, 1e-2):

- JAX bf16 gradient against JAX f32 (the test's bar, when above 1e-2);
- the bf16 cotangent summed in float64 against JAX f32 and against JAX
  bf16: the reading that a port whose cotangent is JAX's to the bit, and
  which sums it exactly, would get;
- the bf16 gradient of a run without the perturbation against the one
  with it, as a check that the perturbation leaves JAX's gradient as it
  was.

Runs the JAX package on the CPU only, and imports no torch.
"""

from __future__ import annotations

import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN  # noqa: E402

C, SCALE, ENC, B, T = 32, 4, 16, 8, 40
PATH = ("Bottle2neck_0", "Conv_2")      # the port's layer1.convs.1


def rel(a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def model(dtype):
    return ECAPA_TDNN(C=C, model_scale=SCALE, n_out=2, n_feat=60,
                      enc_dim=ENC, fused_pool=True, pool_interpret=True,
                      fused_bn=True, dtype=dtype)


def grads(v, feats, dtype, train: bool, perturb: bool = True):
    """(the bias's gradient, the cotangent at the conv's output, zero
    without ``perturb``)."""
    m = model(dtype)
    shape = (B, T, C // SCALE)
    eps0 = jnp.zeros(shape, dtype or jnp.float32)

    def loss(p, eps):
        def add_eps(f, args, kwargs, ctx):
            out = f(*args, **kwargs)
            if (perturb and ctx.method_name == "__call__"
                    and tuple(ctx.module.path) == PATH):
                out = out + eps
            return out

        with nn.intercept_methods(add_eps):
            (e, lg), _ = m.apply({"params": p,
                                  "batch_stats": v["batch_stats"]},
                                 jnp.asarray(feats), train,
                                 mutable=["batch_stats"])
        return jnp.sum(e ** 2) + jnp.sum(lg ** 2)

    gp, ct = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], eps0)
    bias = gp[PATH[0]][PATH[1]]["bias"]
    return np.asarray(bias, np.float32), ct


def main() -> int:
    train = "--train" in sys.argv[1:]
    feats = np.random.default_rng(11).standard_normal((B, T, 60)).astype(
        np.float32)
    v = jax.tree.map(np.asarray, model(None).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(feats), False))
    g32, _ = grads(v, feats, None, train)
    gb, ct = grads(v, feats, jnp.bfloat16, train)
    exact = np.asarray(ct, np.float64).sum(axis=(0, 1))
    plain, _ = grads(v, feats, jnp.bfloat16, train, perturb=False)
    bar = max(rel(gb, g32), 1e-2)
    print(f"{'train' if train else 'eval'} mode, layer1.convs.1.bias "
          f"({'/'.join(PATH)}):")
    print(f"  JAX bf16 vs JAX f32: {rel(gb, g32):.4e} (the bar: {bar:.4e})")
    print(f"  JAX's bf16 cotangent summed in float64 vs JAX f32: "
          f"{rel(exact, g32):.4e}; vs JAX bf16: {rel(exact, gb):.4e}")
    print(f"  JAX bf16 without the perturbation vs with it: "
          f"{rel(plain, gb):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
