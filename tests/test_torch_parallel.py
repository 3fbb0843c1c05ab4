"""The port's multi-GPU layer on the CPU (``parallel/``, the data-parallel
steps, sharded scoring, the member-parallel ensemble), two ranks over gloo
at small shapes (ECAPA C = 32, scale 4, T = 50, F = 60, global B = 16).

Every 2-rank check runs in one spawn (``tests/torch_parallel_workers.py``,
one thread a rank, a 120 s join timeout that kills the ranks), from one
start carried over to both packages by ``interop/flax_weights``; the JAX
references are computed while the ranks run. Each rank's
results are held against the port's one-process step on the global batch
(data parallel is one logical program over the global batch, as JAX's GSPMD
step is) and against the JAX package's step on its virtual mesh (2 of the
8 CPU devices tests/conftest.py forces). Bars: the one-process step at
loss rtol 1e-6 and each gradient within 1e-5 of its tensor's norm; JAX at
the port's f32 trajectory bars (tests/test_torch_train.py): losses rtol
2e-3, BN statistics and the center 5e-3, parameters within 2 lr K."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_workers as W
from asvspoof2021_air_tpu.losses import build_loss
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.parallel import make_mesh as j_make_mesh
from asvspoof2021_air_tpu.parallel import replicate as j_replicate
from asvspoof2021_air_tpu.parallel import shard_batch as j_shard_batch
from asvspoof2021_air_tpu.train import state as jstate
from asvspoof2021_air_tpu.train.ensemble import (
    ensemble_mesh as j_ensemble_mesh,
    make_member_parallel_step as j_member_parallel, member_state)
from asvspoof2021_air_tpu.train.frontend import OnDeviceFrontend as JFrontend
from asvspoof2021_air_tpu.train.steps import StepConfig as JStepConfig
from asvspoof2021_air_tpu.train.steps import make_train_step as j_make_step
from asvspoof2021_air_tpu_torch._device import disable_tf32
from asvspoof2021_air_tpu_torch.data.datasets import (
    ASVspoof2019FeatureDataset)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_train_state, random_flax_variables)
from asvspoof2021_air_tpu_torch.ops.augment import ChannelAugmenter
from asvspoof2021_air_tpu_torch.parallel import (
    Mesh, ShardingError, batch_sharding, host_shard_range,
    initialize_distributed, make_global_batch, make_mesh, shard_batch)
from asvspoof2021_air_tpu_torch.scoring import make_score_fn, score_to_file
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
from asvspoof2021_air_tpu_torch.train.checkpoint import restore_checkpoint
from asvspoof2021_air_tpu_torch.train.loop import setup_training, train
# the references on one thread, as each rank runs: the CPU kernels block
# their sums by the thread count, so only then can a rank's rows match
# them bit for bit
from torch_threads import one_thread  # noqa: F401

disable_tf32()
B, T, F, ENC, SCALE, LR = W.B, W.T, W.F, W.ENC, W.SCALE, W.LR


def jax_system():
    """The JAX ECAPA-32 + ang_iso system of the port's TrainConfig: a
    state maker (the weights of ``random_flax_variables(seed)``, the
    center of the loss's init, the optimizers' initial states: no traced
    init of the model) and the step."""
    model = JECAPA(C=W.C, model_scale=SCALE, n_out=2, n_feat=F, enc_dim=ENC)
    loss = build_loss("ang_iso", enc_dim=ENC)
    sched = jstate.step_decay_schedule(LR, 0.5, 30, W.SPE)
    btx = jstate.make_backbone_optimizer(sched)
    ltx = jstate.make_loss_optimizer(sched)

    def make_state(seed: int):
        v = jax.tree.map(jnp.asarray, random_flax_variables(
            seed, C=W.C, model_scale=SCALE, enc_dim=ENC))
        lp = loss.init(jax.random.PRNGKey(seed), jnp.zeros((B, ENC)),
                       jnp.zeros((B,), jnp.int32))["params"]
        return jstate.TrainState(
            step=0, params=v["params"], batch_stats=v["batch_stats"],
            opt_state=btx.init(v["params"]), loss_params=lp,
            loss_opt_state=ltx.init(lp))

    def step(grad_axis=None, frontend=None):
        return j_make_step(model, loss, btx, ltx,
                           JStepConfig(add_loss="ang_iso"),
                           frontend=frontend, grad_axis=grad_axis)

    return make_state, step


def stack_members(states):
    """JAX's stacked ensemble state of ``states`` (``init_ensemble_state``'s
    layout)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_state(sd):
    return from_flax_train_state(jax.device_get(sd), SCALE)


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):
    """The 2-rank spawn, and meanwhile JAX's mesh steps from the same
    weights."""
    tmp = tmp_path_factory.mktemp("parallel")
    feats = str(tmp / "feats")
    W.write_feature_tree(feats, "train", 2 * B, 1)
    W.write_feature_tree(feats, "dev", 2 * B + 3, 2)
    make_state, jstep = jax_system()
    jstart = make_state(0)
    start = port_state(jstart)
    stacked = stack_members([make_state(3), make_state(4)])
    ens_start = {"step": 0, "members": [port_state(member_state(stacked, i))
                                        for i in range(2)]}
    lcnn = W.config(model="lcnn", add_loss="iso_sq")
    lcnn_start = setup_training(lcnn, W.SPE, device="cpu")[2].state_dict()
    ranks = W.Ranks("run_data_parallel", 2, str(tmp), start=start,
                    ens_start=ens_start, lcnn_start=lcnn_start,
                    feats_root=feats)
    batches = W.feature_batches(3)

    # JAX: the data-parallel step on 2 devices, 2 steps; the
    # member-parallel step on a 2-device 'model' mesh, 1 step
    mesh = j_make_mesh(jax.devices()[:2])
    step = jax.jit(jstep())
    js = j_replicate(jstart, mesh)
    j_losses = []
    for b in batches[:2]:
        js, m = step(js, j_shard_batch(b, mesh), jax.random.PRNGKey(1))
        j_losses.append(float(m["ang_iso"]))
    # the same step on the fly (plain LFCC, no augmenter), 1 step
    fe = OnDeviceFrontend(feat_len=T, device="cpu")
    jfe = JFrontend(feat_len=T, padding="repeat", use_pallas=False)
    wave = W.wave_batch(length=fe.min_samples())
    js_otf, m = jax.jit(jstep(frontend=jfe))(
        j_replicate(jstart, mesh), j_shard_batch(wave, mesh),
        jax.random.PRNGKey(1), 0.0, jfe.params)
    j_otf = dict(loss=float(m["ang_iso"]), end=port_state(js_otf))
    emesh = j_ensemble_mesh(2, jax.devices()[:2])
    sharded = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(emesh, P("model"))),
        stacked)
    je, jm = jax.jit(j_member_parallel(jstep(), 2, emesh))(
        sharded, jbatch(batches[0]), jax.random.PRNGKey(4))
    return dict(tmp=tmp, feats=feats, ranks=ranks.join(120), start=start,
                ens_start=ens_start, lcnn=lcnn, lcnn_start=lcnn_start,
                batches=batches, j_losses=np.array(j_losses),
                j_end=port_state(js),
                j_members=[port_state(member_state(je, i)) for i in range(2)],
                j_member_loss=float(jm["ang_iso"]), j_otf=j_otf)


def one_process_step(cfg, start, batch, frontend=None, rng=None, **kw):
    """(metrics, grads, running stats, the gradients' spread) of the
    one-process step of ``cfg`` from ``start`` on the global ``batch``; the
    spread of each gradient is its error norm, relative to its norm, in the
    same step on the batch with its rows reversed, and the augmenter's and
    the model's draws with them (the same function summed in another
    order)."""
    flip = lambda d: None if d is None else (
        {k: v.flip(0) for k, v in d.items()} if isinstance(d, dict)
        else d.flip(0))
    out = []
    for rev in (False, True):
        _, _, st, step, _ = setup_training(cfg, W.SPE, frontend=frontend,
                                           device="cpu")
        st.load_state_dict(start)
        tb = W.tensors(batch)
        draws = (step.draw(rng, 0, tb), step.draw_model(rng, 0, st.model, tb))
        if rev:
            tb = {k: v.flip(0) for k, v in tb.items()}
            draws = tuple(flip(d) for d in draws)
        m = step(st, tb, rng, draws=draws[0], model_draws=draws[1], **kw)
        out.append((W.host(m), W.host(W.grads(st)), W.host(W.running(st))))
    (metrics, grads, running), (_, rev_grads, _) = out
    spread = {n: np.linalg.norm(rev_grads[n] - g)
              / max(np.linalg.norm(g), 1e-30) for n, g in grads.items()}
    return metrics, grads, running, spread


def assert_step_matches(got: dict, metrics, grads, running, spread,
                        what: str):
    """The ranks' metrics at rtol 1e-6 (both ranks hold the mean), each
    all-reduced gradient's error norm within max(1e-5, 4 x the one-process
    step's own spread with the batch reversed) of its norm (at T = 50 a
    conv bias's gradient moves by up to 1.1e-5 of its norm between the two
    summation orders of the global batch's rows), the BN running
    statistics within 1e-5, of each tensor's largest value where that
    passes 1 (bn7's mean sits near 1e-8). The attention
    BN's bias gets a gradient of rounding noise only (softmax over T
    cancels its shift), so there both are held under 1e-5 of the largest
    gradient element."""
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6,
                                   err_msg=f"{what} {k}")
    top = max(np.abs(g).max() for g in grads.values())
    for n, g in grads.items():
        if n == "attention.2.bias":
            assert max(np.abs(g).max(), np.abs(got["grads"][n]).max()) \
                <= 1e-5 * top, (what, n)
            continue
        if not np.any(g):       # the logits' layers under an add-loss
            np.testing.assert_array_equal(got["grads"][n], g, err_msg=n)
            continue
        err = np.linalg.norm(got["grads"][n] - g) / np.linalg.norm(g)
        assert err <= max(1e-5, 4 * spread[n]), (what, n, err, spread[n])
    for k, v in running.items():
        np.testing.assert_allclose(got["running"][k], v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=f"{what} {k}")


def test_single_process_semantics(monkeypatch):
    """Without a process group: initialize_distributed is a no-op, one
    process loads every item, the mesh is one rank and sharding is the
    identity; a global batch that the ranks do not divide raises; with a
    world named but no GPU the NCCL path raises, never falling back to the
    CPU."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert host_shard_range(100) == range(0, 100)
    mesh = make_mesh("cpu")
    assert (mesh.size(), mesh.index(), mesh.group()) == (1, 0, None)
    batch = {"x": np.arange(12).reshape(6, 2)}
    np.testing.assert_array_equal(shard_batch(batch, mesh)["x"], batch["x"])
    got = make_global_batch(batch, mesh)["x"]
    assert torch.equal(got, torch.as_tensor(batch["x"]))
    two = Mesh(("data",), (2,), {"data": 1}, {"data": None}, "cpu")
    assert batch_sharding(two)(16) == slice(8, 16)
    with pytest.raises(ShardingError, match="does not split"):
        batch_sharding(two)(15)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_sharding_helpers_at_two_ranks(run):
    """At W = 2: host_shard_range halves the items, shard_batch's slices
    (batch axis 0 and 1) are host_shard_range's rows, and make_global_batch
    takes them as they are."""
    for r, res in enumerate(run["ranks"]):
        s = res["shard"]
        assert s["host_range"] == range(50 * r, 50 * (r + 1))
        rows = s["host_range_16"]
        assert s["rows"] == slice(rows.start, rows.stop)
        glob = np.arange(B * 3).reshape(B, 3)
        np.testing.assert_array_equal(s["x"], glob[rows.start:rows.stop])
        np.testing.assert_array_equal(s["y"], np.arange(B)[rows.start:
                                                           rows.stop])
        np.testing.assert_array_equal(s["stacked"],
                                      np.stack([s["x"]] * 2))
        np.testing.assert_array_equal(s["global_batch"]["x"], s["x"])


@pytest.mark.parametrize("mode", W.BN_MODES)
def test_batch_norm_across_ranks_equals_the_global_batch(run, mode):
    """Each BN mode on 2 ranks of 8 rows against the one-process call on
    16: y and dx (the ranks' rows joined), mu and var (on each rank), and
    dscale and dbias (the ranks' sums added, as the gradient all-reduce
    adds them), within 1e-5 of each tensor's largest value; nonzero
    cotangents on (mu, var) are split over the ranks."""
    want = W.bn_case(mode, *W.bn_inputs())
    got = [r["bn"][mode] for r in run["ranks"]]
    names = ("y", "mu", "var", "dx", "dscale", "dbias")
    for i, name in enumerate(names):
        if name in ("y", "dx"):
            g = np.concatenate([x[i] for x in got])
        elif name in ("dscale", "dbias"):
            g = got[0][i] + got[1][i]
        else:
            np.testing.assert_array_equal(got[0][i], got[1][i])
            g = got[0][i]
        np.testing.assert_allclose(g, want[i], rtol=0,
                                   atol=1e-5 * np.abs(want[i]).max(),
                                   err_msg=f"{mode} {name}")


def test_data_parallel_step_equals_one_process_step(run):
    """The 2-rank ECAPA ang_iso step from features: both ranks' metrics,
    all-reduced gradients and BN statistics against the one-process step
    on the global batch; the two ranks' states stay bitwise equal."""
    ref = one_process_step(W.config(), run["start"], run["batches"][0])
    for r in run["ranks"]:
        assert_step_matches(r["dp_step1"], *ref, "dp")
    a, b = (r["dp_end"]["state"] for r in run["ranks"])
    for k, v in a["model"].items():
        np.testing.assert_array_equal(v, b["model"][k], err_msg=k)


def test_data_parallel_steps_track_jax_mesh_step(run):
    """Two data-parallel steps against JAX's jitted step over a 2-device
    data mesh (shard_batch, GSPMD), from the same weights: the f32
    trajectory bars."""
    r = run["ranks"][0]
    losses = [float(r["dp_step1"]["metrics"]["ang_iso"]),
              float(r["dp_end"]["metrics"]["ang_iso"])]
    check_trajectory(losses, run["j_losses"], r["dp_end"]["state"],
                     run["j_end"], 2)


def check_trajectory(got_losses, want_losses, got, want, k: int):
    """The port's f32 trajectory bars (tests/test_torch_train.py) after
    ``k`` steps: losses rtol 2e-3, BN statistics and the center atol
    5e-3, parameters within 2 lr k."""
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-3)
    assert got["step"] == want["step"] == k
    for key, w in want["model"].items():
        atol = 5e-3 if key.endswith(("running_mean", "running_var")) \
            else 2 * LR * k
        np.testing.assert_allclose(got["model"][key], w.numpy(), rtol=0,
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(got["loss_module"]["center"],
                               want["loss_module"]["center"].numpy(),
                               atol=5e-3)


def test_on_the_fly_step_tracks_jax_mesh_step(run):
    """The 2-rank step on the fly (LFCC inside the step, no augmenter)
    against JAX's jitted step with its jnp LFCC front-end over a 2-device
    data mesh, from the same weights: one step at the f32 trajectory
    bars (the two LFCCs agree within 5e-4, tests/test_torch_augment.py)."""
    for r in run["ranks"]:
        got = r["otf_lfcc"]
        check_trajectory([float(got["metrics"]["ang_iso"])],
                         [run["j_otf"]["loss"]], got["state"],
                         run["j_otf"]["end"], 1)


def test_on_the_fly_draws_are_global_and_sliced(run):
    """On the fly with the channel augmenter: the augmenter draws for the
    global batch from the step's generator and each rank keeps its rows,
    so the 2-rank step equals the one-process step with the same seed."""
    fe = OnDeviceFrontend(feat_len=T, augmenter=ChannelAugmenter(
        device="cpu"), device="cpu")
    cfg = dataclasses.replace(W.config(), on_the_fly=True,
                              on_device_aug=True)
    ref = one_process_step(
        cfg, run["start"], W.wave_batch(length=fe.min_samples()), fe,
        rng=11, frontend_params=fe.params)
    for r in run["ranks"]:
        assert_step_matches(r["otf"], *ref, "otf")


def test_lcnn_dropout_draws_are_sliced(run):
    """LCNN + iso_sq draws its dropout mask for the global batch and each
    rank keeps its rows: the 2-rank step equals the one-process one."""
    ref = one_process_step(run["lcnn"], run["lcnn_start"],
                           run["batches"][0], rng=5)
    for r in run["ranks"]:
        assert_step_matches(r["lcnn"], *ref, "lcnn")


def test_k_steps_per_call_equal_single_steps(run):
    """make_multi_step(K = 2) of the data-parallel step (a loop on CPU
    tensors) against two single steps: bitwise."""
    assert all(r["multi_equal"] for r in run["ranks"])


def test_graph_of_steps_over_gloo_is_refused(run):
    """A CUDA graph of K steps captures NCCL's all-reduces only: a step
    over gloo raises ValueError naming the backend before any capture."""
    for r in run["ranks"]:
        assert "gloo" in r["gloo_capture_refused"]


def test_checkpoint_resume_is_bitwise(run):
    """Rank 0 saves, both ranks restore into fresh states and take a step:
    bitwise what continuing without the restore gives."""
    assert all(r["resume_equal"] for r in run["ranks"])


def test_sharded_scoring_file_equals_one_process_file(run):
    """2 B + 3 feature files (a ragged last batch) scored over 2 ranks:
    rank 0's file is the one-process file, byte for byte."""
    fn = make_score_fn(run["start"]["model"], model_scale=SCALE,
                       device="cpu")
    ds = ASVspoof2019FeatureDataset("LA", run["feats"], "dev")
    one = score_to_file(fn, ds, str(run["tmp"] / "one.txt"), True,
                        batch_size=B, feat_len=T)
    with open(one) as f:
        want = f.read()
    with open(run["tmp"] / "sharded.txt") as f:
        got = f.read()
    assert len(want.splitlines()) == 2 * B + 3
    assert got == want


def test_member_parallel_equals_one_card_ensemble(run):
    """M = 2 over 2 ranks (one member each) against the one-card ensemble
    step from the same members: each member's state (expected bitwise;
    JAX's bar, rtol 2e-4 and atol 1e-5), the member-averaged metrics."""
    ens = dataclasses.replace(W.config(), ensemble=2)
    _, _, st, step, _ = setup_training(ens, W.SPE, device="cpu")
    st.load_state_dict(run["ens_start"])
    m = W.host(step(st, W.tensors(run["batches"][0])))
    want = st.state_dict()["members"]
    bitwise = 0
    for r in run["ranks"]:
        res = r["member"]
        (i,), (got,) = res["ids"], res["state"]
        for k, v in want[i]["model"].items():
            np.testing.assert_allclose(got["model"][k], v.numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=k)
            bitwise += np.array_equal(got["model"][k], v.numpy())
        for k, v in m.items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-6)
    assert sorted(r["member"]["ids"][0] for r in run["ranks"]) == [0, 1]
    assert bitwise == 2 * len(want[0]["model"])


def test_member_parallel_tracks_jax(run):
    """The member-parallel step against JAX's make_member_parallel_step on
    a 2-device 'model' mesh: each member at the f32 trajectory bars (one
    step), the mean loss at rtol 2e-3."""
    for r in run["ranks"]:
        (i,), (got,) = r["member"]["ids"], r["member"]["state"]
        want = run["j_members"][i]
        for k, w in want["model"].items():
            atol = 5e-3 if k.endswith(("running_mean", "running_var")) \
                else 2 * LR
            np.testing.assert_allclose(got["model"][k], w.numpy(), rtol=0,
                                       atol=atol, err_msg=k)
        np.testing.assert_allclose(float(r["member"]["metrics"]["ang_iso"]),
                                   run["j_member_loss"], rtol=2e-3)


def test_train_over_two_ranks(run):
    """train() from features over the 2-rank mesh: rank 0 alone writes
    one log row per step and the checkpoints; its summary and state match
    a one-process train() of the same config (the f32 trajectory bars);
    auto_resume to a third epoch loads on both ranks, which stay bitwise
    equal."""
    cfg = W.config(path_to_features=run["feats"], num_epochs=2, ratio=1.0,
                   out_fold=str(run["tmp"] / "one_run"))
    summary, state = train(cfg, device="cpu", return_state=True)
    got = run["ranks"][0]["train"]
    np.testing.assert_allclose(got["summary"]["dev_loss"],
                               summary["dev_loss"], rtol=2e-3)
    assert got["summary"]["epochs"] == 2
    want = state.state_dict()
    for k, v in want["model"].items():
        atol = 5e-3 if k.endswith(("running_mean", "running_var")) \
            else 2 * LR * 4
        np.testing.assert_allclose(got["state"]["model"][k], v.numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    out = run["tmp"] / "run"
    with open(out / "train_loss.log") as f:
        rows = [line.split()[:2] for line in f.readlines()[1:]]
    assert rows == [[str(e), str(i)] for e in range(3) for i in range(2)]
    for name in ("best.pt", "train_meta.json", "checkpoint/3.pt"):
        assert os.path.exists(out / name), name
    a, b = (r["train3"]["state"] for r in run["ranks"])
    assert a["step"] == b["step"] == 6
    for k, v in a["model"].items():
        np.testing.assert_array_equal(v, b["model"][k], err_msg=k)


def test_train_of_an_ensemble_spreads_its_members(run):
    """train() with ensemble=2 over 2 ranks trains one member a rank
    (member-parallel): the summary and each member as the one-card
    ensemble's train() (expected bitwise; JAX's ensemble bar, rtol 2e-4
    and atol 1e-5); rank 0's checkpoint holds both members, gathered."""
    cfg = W.config(path_to_features=run["feats"], num_epochs=1, ratio=1.0,
                   ensemble=2, out_fold=str(run["tmp"] / "one_ens"))
    summary, state = train(cfg, device="cpu", return_state=True)
    want = state.state_dict()["members"]
    for r, res in enumerate(run["ranks"]):
        got = res["ens_train"]
        assert list(got["ids"]) == [r]
        np.testing.assert_allclose(got["summary"]["dev_loss"],
                                   summary["dev_loss"], rtol=1e-6)
        assert got["summary"]["dev_eer"] == summary["dev_eer"]
        for k, v in want[r]["model"].items():
            np.testing.assert_allclose(got["members"][0]["model"][k],
                                       v.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=k)
    saved = restore_checkpoint(str(run["tmp"] / "ens_run" / "best.pt"))
    assert len(saved["members"]) == 2
    for i in range(2):
        np.testing.assert_array_equal(
            saved["members"][i]["model"]["conv1.weight"].numpy(),
            run["ranks"][i]["ens_train"]["members"][0]["model"][
                "conv1.weight"])
