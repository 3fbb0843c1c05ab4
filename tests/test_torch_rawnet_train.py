"""The port's RawNet2 training on the CPU at the tiny arguments of
tests/test_train_loop.py: a 4-step trajectory with the base CE against
the JAX step (run eagerly: tests/test_torch_rawnet.py says why), and
``train()`` on the fly with the channel augmenter. The helpers are
tests/test_torch_train_families.py's."""

import os

import numpy as np
import pytest

from asvspoof2021_air_tpu_torch.train.loop import TrainConfig, train
from test_torch_train import _write_part
from test_torch_train_families import (  # noqa: F401  (the fixture)
    B, RAWNET_TINY, _two_threads, check_trajectory, trajectory)


def test_rawnet_trajectory_tracks_jax():
    """RawNet2 with the base CE (no add-loss: its embedding is the
    logits), 4 steps from one mid-training state against the eager JAX
    step, by ``check_trajectory``'s bars; the conv1 biases, whose gradient
    feeds a train-mode BN and is zero in exact arithmetic, by the
    parameters' bar alone (Adam scales their rounding noise to steps of
    the rate in both packages)."""
    t = trajectory("rawnet", None, jit=False)
    check_trajectory(t, None, noise=(".conv1.bias",))
    assert all(d is None for d in t["draws"])


def test_train_rawnet_on_the_fly_with_the_augmenter(tmp_path):
    """``train()`` of RawNet2 on the fly with the channel augmenter, two
    steps a call (a loop on the CPU), two epochs: the logs, the summary,
    BN statistics moved; with an add-loss, or from feature files, it
    raises ValueError (the first as the JAX ``setup_training``)."""
    db = str(tmp_path / "db")
    _write_part(db, "train", 16, 2, 5000)
    _write_part(db, "dev", 8, 3, 7000)
    base = dict(out_fold=str(tmp_path / "out"), path_to_database=db,
                model="rawnet", rawnet_args=RAWNET_TINY, batch_size=B,
                ratio=1.0, num_epochs=2)
    cfg = TrainConfig(on_the_fly=True, on_device_aug=True, steps_per_call=2,
                      **base)
    summary, state = train(cfg, device="cpu", return_state=True)
    assert summary["epochs"] == 2 and np.isfinite(summary["dev_loss"])
    assert state.step == 4 and 0 <= summary["dev_eer"] <= 1
    with open(os.path.join(cfg.out_fold, "train_loss.log")) as f:
        assert len(f.readlines()) == 1 + 4
    with pytest.raises(ValueError, match="rawnet"):
        train(TrainConfig(on_the_fly=True, add_loss="ang_iso", **base),
              device="cpu")
    with pytest.raises(ValueError, match="on_the_fly"):
        train(TrainConfig(**base), device="cpu")
