"""The port's ResNet18 training against the JAX package, on the CPU at
its full widths and B = 8, T = 32: 4-step trajectories from one
mid-training state with isolate, ang_iso and no add-loss, each with the
JAX model's own pooling noise (its ``noise`` stream) injected into the
port's steps. The helpers are tests/test_torch_train_families.py's."""

import numpy as np
import pytest
import torch

from test_torch_train_families import (
    B, FRAMES, check_trajectory, trajectory)
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("add_loss", ["isolate", "ang_iso", None])
def test_resnet_trajectory_tracks_jax_with_its_noise(add_loss):
    """ResNet18, 4 steps, JAX's pooling noise injected: losses rtol 2e-3,
    BN statistics and loss parameters atol 5e-3, parameters within 2 lr K,
    the updates and Adam moments by ``check_updates``; the noise is
    standard normal at (B, T', 256), T' = 4 for T = 32. A BN statistic's
    bar is max(5e-3, 4 (s_jax + s_port)), s being each package's own
    spread: the statistic's change when the K steps run again on every
    batch with its rows (and the noise's rows) reversed, the same steps in
    exact arithmetic. Adam steps every weight by up to lr on the sign of
    its gradient, so two f32 runs part wherever a gradient is at rounding
    level, by an amount that depends on the host's rounding: on one host
    ang_iso's bn5.running_mean read 7.97e-3 between the packages against
    the old 5e-3."""
    t = trajectory("resnet", add_loss, spread=True)
    check_trajectory(t, add_loss)
    noise = np.stack(t["draws"])
    assert noise.shape[1:] == (B, 4, 256)
    assert abs(noise.std() - 1) < 0.05 and abs(noise.mean()) < 0.05
    # fc_mu gets no gradient from an add-loss, but coupled L2 moves its
    # weight in both packages (the port gives it a zero gradient)
    if add_loss is not None:
        got = t["got"]["model"]["fc_mu.weight"]
        assert not torch.equal(got, t["start"]["model"]["fc_mu.weight"])
