"""The port's SE-Res2Net50 training against the JAX package, on the CPU at
its fixed widths and B = 8, T = 24: a 4-step trajectory with ang_iso from
one mid-training state. The helpers are
tests/test_torch_train_families.py's."""

from test_torch_train_families import (  # noqa: F401  (the fixture)
    _two_threads, check_trajectory, trajectory)


def test_res2net_trajectory_tracks_jax():
    """SE-Res2Net50 + ang_iso (its 256-dim embedding), 4 steps: losses
    rtol 2e-3, BN statistics and the center atol 5e-3, parameters within
    2 lr K, each tensor's update by cosine (0.9) and norm (10%) and the
    whole model's by ``check_updates`` (read: losses 3.2e-5 apart, cosine
    0.987 at least, norms 0.943-1.034 of JAX's). Each package's f32
    gradient of this model moves by up to 6.2e-2 of a tensor's norm when
    the same batch is summed in another order (tests/test_torch_res2net.py,
    ReLU inputs rounded to the other side of zero), so the update norms
    are held at 10%, not 5%, and the Adam moments not per tensor: a
    moment's change, 0.1 (g - m), carries that noise against a difference
    that the steps' steady gradients keep small (read: 0.43 of the change
    of the first stage's SE weights)."""
    t = trajectory("res2net", "ang_iso")
    check_trajectory(t, "ang_iso", moments=False, norm_bar=0.1)
    assert all(d is None for d in t["draws"])
