"""``correct`` comes out false when the timed path is broken underneath.

Each case drives the rest of a run (``run.measure`` on the CPU at a tiny
size, past the harness's look for a card) with one fault planted in the
program, and the cell's own limits: a training step that leaves its state
unchanged, half of each batch left out with the mean taken over the rest,
the learning rate doubled, an answer altered where it is produced. The
same run without the fault is correct. The configuration computes in float32 here, so that the sound
run reads round-off only at these sizes.

Marked ``chip``: the control (the reference with float8 products in the
program's place) and the program at a cell's own size, on the card, on
either side of the cell's limits.
"""

import pytest
import torch

from portbench import run
from portbench.harness import bench, inputs

SCORE = {"config": {"feat_len": 40, "compute_dtype": "float32"},
         "traffic": {"batch": 6, "pool_batches": 2, "max_samples": 39 * 160}}
TRAIN = {"config": {"feat_len": 40, "compute_dtype": "float32"},
         "traffic": {"batch": 8, "pool_batches": 4, "steps_per_call": 4,
                     "feat_len": 40}}


def _measure(workload, over):
    over = {k: dict(v) for k, v in over.items()}
    if workload.startswith("ecapa"):
        over["config"]["channels"] = 32
    return run.measure(workload, 2**31 + 17, 0.2, False, device="cpu",
                       overrides=over)


def _alter_scores(monkeypatch, how):
    from asvspoof2021_air_tpu_torch import scoring

    rule = scoring.score_rule

    def broken(*args, **kw):
        out = rule(*args, **kw).clone()
        how(out)
        return out

    monkeypatch.setattr(scoring, "score_rule", broken)


def _half_batch(monkeypatch):
    from asvspoof2021_air_tpu_torch.train import steps

    losses = steps._losses

    def broken(state, config, x, labels, batch, model_draws, adv_gate, dev):
        n = x.shape[0] // 2
        draws = None if model_draws is None else model_draws[:n]
        return losses(state, config, x[:n], labels[:n], batch, draws,
                      adv_gate, dev)

    monkeypatch.setattr(steps, "_losses", broken)


def _unchanged(monkeypatch):
    from asvspoof2021_air_tpu_torch.train.state import TrainState

    def broken(self, group=None):
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_gradients", broken)


def _double_rate(monkeypatch):
    from asvspoof2021_air_tpu_torch.train.state import TrainState

    rate = TrainState.set_rate

    def broken(self):
        rate(self)
        if self.capturable:
            self.lr.mul_(2)
            return
        for opt in self.optimizers():
            for group in opt.param_groups:
                group["lr"] = 2 * group["lr"]

    monkeypatch.setattr(TrainState, "set_rate", broken)


def _altered_loss(monkeypatch):
    from asvspoof2021_air_tpu_torch.train import steps

    losses = steps._losses

    def broken(*args):
        metrics, total, clf = losses(*args)
        return metrics, 1.5 * total, clf

    monkeypatch.setattr(steps, "_losses", broken)


SCORE_FAULTS = {
    "answer_altered": lambda mp: _alter_scores(
        mp, lambda s: s.__setitem__(0, s[0] + 0.1)),
    "half_the_rows_unscored": lambda mp: _alter_scores(
        mp, lambda s: s[s.shape[0] // 2:].zero_()),
}
TRAIN_FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
                "double_rate": _double_rate, "answer_altered": _altered_loss}


@pytest.mark.parametrize("workload", ["ecapa512-score-wave",
                                      "resnet18-score-wave"])
def test_sound_scoring_run_is_correct(workload):
    got = _measure(workload, SCORE)
    assert got["correct"], got["checks"]


@pytest.mark.parametrize("fault", sorted(SCORE_FAULTS))
@pytest.mark.parametrize("workload", ["ecapa512-score-wave",
                                      "resnet18-score-wave"])
def test_broken_scoring_run_is_not_correct(workload, fault, monkeypatch):
    SCORE_FAULTS[fault](monkeypatch)
    got = _measure(workload, SCORE)
    assert not got["correct"], got["checks"]


@pytest.mark.parametrize("workload", ["ecapa512-train-feat-k8",
                                      "resnet18-train-feat-k8"])
def test_sound_training_run_is_correct(workload):
    got = _measure(workload, TRAIN)
    assert got["correct"], got["checks"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("workload", ["ecapa512-train-feat-k8",
                                      "resnet18-train-feat-k8"])
def test_broken_training_run_is_not_correct(workload, fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    got = _measure(workload, TRAIN)
    assert not got["correct"], got["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", [31, 32, 33, 34, 35, 36])
@pytest.mark.parametrize("workload", ["ecapa512-score-wave",
                                      "resnet18-score-wave",
                                      "ecapa512-train-feat-k8",
                                      "resnet18-train-feat-k8"])
def test_control_fails_and_program_passes_on_the_card(workload, seed, card):
    """On the seeds the control's readings were taken on."""
    from portbench import calibrate

    cell = bench.Cell(workload)
    weights = inputs.make_weights(
        cell.config_module.param_spec(cell.config), seed, card)
    task = cell.task.Task(cell, seed, card, weights)
    task.setup()
    if cell.task.UNIT == "batch":
        task.run(seconds=1.0)
        task.release()
        got = calibrate.score_readings(task, True)
    else:
        task.release()
        got = calibrate.train_readings(task, True)
    assert bench.judge(got["program"], cell.limits)["ok"], got["program"]
    assert not bench.judge(got["control"], cell.limits)["ok"], got["control"]
    torch.cuda.empty_cache()
