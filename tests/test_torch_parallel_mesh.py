"""The port's 2-D member x data ensemble step on the CPU: 4 ranks over
gloo (tests/torch_parallel_workers.py) on a 2 x 2 ("model", "data") mesh,
ECAPA C = 32 + ang_iso from features, global B = 16 (8 rows a data shard:
train-mode BN needs them), against the JAX package's
make_member_data_parallel_step over member_data_mesh(2, 2) of 4 virtual
CPU devices, from the same weights, computed while the ranks run.

Both are per-replica BN (JAX's grad_axis="data"): each shard normalizes
with its own moments, and the gradients, metrics and running statistics
are averaged over "data". Bars: the port's f32 trajectory bars (losses
rtol 2e-3, BN statistics and the center 5e-3, parameters within 2 lr K,
K = 2 steps); a member's replicas bitwise equal across its data shards,
as tests/test_ensemble.py asks of JAX's."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_workers as W
from asvspoof2021_air_tpu_torch.train.checkpoint import restore_checkpoint
from asvspoof2021_air_tpu.train.ensemble import (
    make_member_data_parallel_step as j_member_data, member_data_mesh,
    member_state)
from test_torch_parallel import (
    jax_system, jbatch, port_state, stack_members)
from torch_threads import one_thread  # noqa: F401

LR, K = W.LR, 2
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):
    tmp = tmp_path_factory.mktemp("mesh")
    feats = str(tmp / "feats")
    W.write_feature_tree(feats, "train", 2 * W.B, 1)
    W.write_feature_tree(feats, "dev", 2 * W.B + 3, 2)
    make_state, jstep = jax_system()
    stacked = stack_members([make_state(5), make_state(6)])
    start = {"step": 0, "members": [port_state(member_state(stacked, i))
                                    for i in range(2)]}
    ranks = W.Ranks("run_member_data", 4, str(tmp), start=start,
                    feats_root=feats, n_steps=K)
    train_cli = cli(2, "train", "-f", feats, "-o", str(tmp / "runs" / "cli"),
                    "-m", "ecapa", "--add_loss", "ang_iso", "--C", str(W.C),
                    "--model_scale", str(W.SCALE), "--enc_dim", str(W.ENC),
                    "--feat_len", str(W.T), "--batch_size", str(W.B),
                    "--num_epochs", "1", "--ratio", "1.0")
    mesh = member_data_mesh(2, 2, jax.devices()[:4])
    state = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("model"))),
        stacked)
    step = jax.jit(j_member_data(jstep(grad_axis="data"), 2, mesh))
    losses = []
    for b in W.feature_batches(K, seed=9):
        state, m = step(state, jbatch(b), jax.random.PRNGKey(6))
        losses.append(float(m["ang_iso"]))
    train_out = finish(train_cli)
    score = [cli(n, "generate_score", "--model_folder", str(tmp / "runs"),
                 "-n", "cli", "-t", "19dev", "--ori_features", feats,
                 "--batch_size", str(W.B), cwd=tmp / f"score{n}")
             for n in (2, 1)]
    return dict(tmp=tmp, ranks=ranks.join(120), j_losses=np.array(losses),
                j_members=[port_state(member_state(state, i))
                           for i in range(2)],
                train_out=train_out, score_out=[finish(p) for p in score])


def cli(n: int, name: str, *args, cwd=None):
    """``torchrun --nproc_per_node=n -m ...cli.<name> <args> --device cpu``
    (one plain process for n = 1), started."""
    import os
    import subprocess
    import sys

    cwd = cwd or os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    launch = ([sys.executable, "-m", "torch.distributed.run",
               f"--nproc_per_node={n}", f"--master_port={W.free_port()}"]
              if n > 1 else [sys.executable])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        launch + ["-m", f"asvspoof2021_air_tpu_torch.cli.{name}", *args,
                  "--device", "cpu"], cwd=cwd, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish(proc, timeout: float = 120.0) -> str:
    """A started CLI's output; a failure or a run past ``timeout``
    (killed) raises."""
    import subprocess

    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out
    return out


def test_ranks_lay_out_members_by_data_shards(run):
    """Rank m 2 + j holds member m's data shard j."""
    for r, res in enumerate(run["ranks"]):
        assert tuple(res["coords"]) == (r // 2, r % 2)
        assert list(res["ids"]) == [r // 2]


def test_member_replicas_are_bitwise_equal_and_members_differ(run):
    """After 2 steps each member's parameters, BN statistics, center and
    Adam states are bitwise equal on its two data shards; the two members
    differ."""
    states = [res["state"][0] for res in run["ranks"]]
    for m in range(2):
        a, b = states[2 * m], states[2 * m + 1]
        assert a["step"] == b["step"] == K
        for k, v in a["model"].items():
            np.testing.assert_array_equal(v, b["model"][k], err_msg=k)
        np.testing.assert_array_equal(a["loss_module"]["center"],
                                      b["loss_module"]["center"])
        for n, st in a["optimizer"].items():
            for k, v in st.items():
                np.testing.assert_array_equal(v, b["optimizer"][n][k])
    w0, w1 = states[0]["model"], states[2]["model"]
    assert not np.allclose(w0["conv1.weight"], w1["conv1.weight"])


def test_member_data_step_tracks_jax_member_data_mesh(run):
    """Each member after 2 steps against JAX's member x data step over
    member_data_mesh(2, 2), and the metrics (averaged over data, members
    and "model") at the f32 trajectory bars."""
    losses = [float(m["ang_iso"]) for m in run["ranks"][0]["metrics"]]
    np.testing.assert_allclose(losses, run["j_losses"], rtol=2e-3)
    for res in run["ranks"][::2]:
        (i,), (got,) = res["ids"], res["state"]
        want = run["j_members"][i]
        assert got["step"] == want["step"] == K
        for k, w in want["model"].items():
            atol = 5e-3 if k.endswith(("running_mean", "running_var")) \
                else 2 * LR * K
            np.testing.assert_allclose(got["model"][k], w.numpy(), rtol=0,
                                       atol=atol, err_msg=k)
        np.testing.assert_allclose(got["loss_module"]["center"],
                                   want["loss_module"]["center"].numpy(),
                                   atol=5e-3)
    assert all(np.isfinite(losses))
    assert torch.get_num_threads() == 1


def test_train_over_the_member_data_mesh_gathers_and_resumes(run):
    """train() with ensemble=2 over 4 ranks spreads the members over a
    2 x 2 member x data mesh: after an epoch and an auto_resume to a
    second, each member's replicas are bitwise equal, rank 0's
    checkpoint holds both members as the ranks hold them, and every rank
    reports the same dev loss."""
    res = [r["train"] for r in run["ranks"]]
    assert [list(r["ids"]) for r in res] == [[0], [0], [1], [1]]
    assert len({r["summary"]["dev_loss"] for r in res}) == 1
    assert all(r["summary"]["epochs"] == 2 for r in res)
    saved = restore_checkpoint(str(run["tmp"] / "run" / "checkpoint" /
                                   "2.pt"))
    assert saved["step"] == 4 and len(saved["members"]) == 2
    for m in range(2):
        a, b = res[2 * m]["members"][0], res[2 * m + 1]["members"][0]
        for k, v in a["model"].items():
            np.testing.assert_array_equal(v, b["model"][k], err_msg=k)
            np.testing.assert_array_equal(
                saved["members"][m]["model"][k].numpy(), v, err_msg=k)


def test_both_clis_run_under_torchrun(run):
    """``torchrun --nproc_per_node=2`` of cli.train (ECAPA-32 from features,
    one epoch, gloo with --device cpu): rank 0 alone prints the summary
    and writes the run folder; then cli.generate_score of that run under
    torchrun writes the file that one process writes, byte for byte
    (2 B + 3 files: a ragged last batch)."""
    assert run["train_out"].count("'dev_eer'") == 1, run["train_out"]
    run_dir = run["tmp"] / "runs" / "cli"
    for name in ("args.json", "best.pt", "checkpoint/1.pt"):
        assert (run_dir / name).exists(), name
    with open(run_dir / "train_loss.log") as f:
        assert len(f.readlines()) == 1 + 2          # two steps, one writer
    two, one = (run["tmp"] / f"score{n}" / "scores" / "cli_19dev_score.txt"
                for n in (2, 1))
    assert two.read_text() == one.read_text()
    assert len(one.read_text().splitlines()) == 2 * W.B + 3
    assert run["score_out"][0].count("wrote") == 1
