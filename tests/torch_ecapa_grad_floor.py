"""Readings behind the gradient bar of
``test_torch_train.test_ecapa_train_mode_matches_jax``, on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_ecapa_grad_floor.py

For the test's small train-mode ECAPA and its loss, prints the worst
element of each comparison as a multiple of the JAX test's unscaled bar
(atol 2e-4, rtol 5e-3), naming the tensor:

- the port's gradients against the JAX package's jitted ones;
- the JAX package's own eager gradients against its jitted ones, the f32
  noise floor of that bar (its eager Pallas pass takes ~30 s);
- the port's against the jitted ones under the test's scaled bar (atol
  2e-4 times max(1, the tensor's largest |gradient|)).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from asvspoof2021_air_tpu_torch.interop.flax_weights import (  # noqa: E402
    from_flax_variables)
from tests.test_torch_train import (  # noqa: E402
    B, SCALE, T, _jmodel, _params_only, _port_model)


def _worst(got, want, scaled=False):
    """(tensor, multiple of the bar) of the worst element over tensors."""
    out = {}
    for n, w in want.items():
        g, w = got[n], w.numpy()
        atol = 2e-4 * (max(1.0, float(np.abs(w).max())) if scaled else 1.0)
        out[n] = float(np.max(np.abs(g - w) / (atol + 5e-3 * np.abs(w))))
    name = max(out, key=out.get)
    return name, out[name]


def main():
    feats = np.random.default_rng(11).standard_normal((B, T, 60)).astype(
        np.float32)
    model = _jmodel()
    v = jax.tree.map(np.asarray, model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(feats), False))

    def loss(p):
        (e, lg), _ = model.apply(
            {"params": p, "batch_stats": v["batch_stats"]},
            jnp.asarray(feats), True, mutable=["batch_stats"])
        return jnp.sum(e ** 2) + jnp.sum(lg ** 2)

    def as_port(g):
        return _params_only(from_flax_variables(jax.tree.map(np.asarray, {
            "params": g, "batch_stats": v["batch_stats"]}), SCALE))

    jitted = as_port(jax.jit(jax.grad(loss))(v["params"]))
    eager = as_port(jax.grad(loss)(v["params"]))
    port = _port_model().train()
    port.load_state_dict(from_flax_variables(v, SCALE))
    pe, pl = port(torch.from_numpy(feats))
    (pe.pow(2).sum() + pl.pow(2).sum()).backward()
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    for what, (name, r) in (
            ("port vs JAX jitted, unscaled bar", _worst(got, jitted)),
            ("JAX eager vs JAX jitted, unscaled bar",
             _worst({n: t.numpy() for n, t in eager.items()}, jitted)),
            ("port vs JAX jitted, the test's scaled bar",
             _worst(got, jitted, scaled=True))):
        print(f"{what}: {r:.3f} x the bar ({name})")


if __name__ == "__main__":
    main()
