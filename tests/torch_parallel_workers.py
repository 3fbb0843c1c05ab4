"""Workers of the port's multi-process CPU tests
(tests/test_torch_parallel*.py).

Each test spawns W processes over gloo on 127.0.0.1, each on one thread
(``torch.set_num_threads(1)``: several ranks sharing the cores otherwise
run a few seconds' work for minutes), and runs one of the ``run_*``
functions below in every rank (:class:`Ranks`); a rank writes what it
computed with ``torch.save`` and the test compares it with the
one-process step and with the JAX package. This module imports torch,
numpy and the port only, so a spawned rank does not import JAX.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

C, SCALE, ENC, T, F, B = 32, 4, 16, 50, 60, 16
LR = 5e-4
SPE = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(name: str, rank: int, world: int, port: int, out_dir: str,
           kwargs: dict) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        result = globals()[name](rank, world, out_dir, **kwargs)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        os._exit(1)


class Ranks:
    """``world`` spawned ranks running ``name(rank, world, out_dir,
    **kwargs)`` over gloo; :meth:`join` waits for them."""

    def __init__(self, name: str, world: int, out_dir: str, **kwargs):
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self.name, self.world, self.out_dir = name, world, out_dir
        self.procs = [ctx.Process(target=_entry,
                                  args=(name, r, world, port, out_dir,
                                        kwargs), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.started = time.monotonic()

    def join(self, timeout: float = 120.0) -> list:
        """Each rank's result. A rank that fails, or ranks still running
        ``timeout`` seconds after the start (then killed), raise."""
        deadline = self.started + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung:
            raise TimeoutError(f"{self.name}: {len(hung)} of {self.world} "
                               f"ranks still running after {timeout} s, "
                               "killed")
        codes = [p.exitcode for p in self.procs]
        if any(codes):
            raise RuntimeError(f"{self.name}: ranks exited with {codes}")
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


# ---------------------------------------------------------------- inputs


def feature_batches(n: int, seed: int = 0, batch: int = B) -> list:
    """``n`` global batches of features and alternating labels."""
    g = np.random.default_rng(seed)
    labels = (np.arange(batch) % 2).astype(np.int32)
    out = []
    for _ in range(n):
        feat = g.standard_normal((batch, T, F)).astype(np.float32)
        feat += 0.5 * labels[:, None, None]
        out.append({"feat": feat, "label": labels})
    return out


def wave_batch(seed: int = 1, length: int = (T - 1) * 160) -> dict:
    g = np.random.default_rng(seed)
    labels = (np.arange(B) % 2).astype(np.int32)
    wave = (0.1 * g.standard_normal((B, length))).astype(np.float32)
    lengths = np.full(B, length, np.int32)
    lengths[::3] = length - 700
    return {"wave": wave, "length": lengths, "label": labels}


def tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def config(**kw):
    from asvspoof2021_air_tpu_torch.train.loop import TrainConfig

    base = dict(model="ecapa", add_loss="ang_iso", C=C, model_scale=SCALE,
                enc_dim=ENC, feat_len=T, batch_size=B, lr=LR)
    base.update(kw)
    return TrainConfig(**base)


def grads(state) -> dict:
    out = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    if state.loss_module is not None:
        out["center"] = state.loss_module.center.grad.clone()
    return out


def running(state) -> dict:
    return {k: v.clone() for k, v in state.model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def host(x):
    """Tensors of a nested result as numpy (plain data for the parent)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [host(v) for v in x]
    return x


def bn_inputs(seed: int = 3, n: int = B, c: int = 8, t: int = 10):
    g = np.random.default_rng(seed)
    x = (1.0 + 2.0 * g.standard_normal((n, c, t))).astype(np.float32)
    gy = g.standard_normal((n, c, t)).astype(np.float32)
    scale = (1 + 0.1 * g.standard_normal(c)).astype(np.float32)
    bias = (0.1 * g.standard_normal(c)).astype(np.float32)
    gmu, gvar = (g.standard_normal(c).astype(np.float32) for _ in range(2))
    return x, gy, scale, bias, gmu, gvar


BN_MODES = ("relu_bn", "bn_relu", "bn_leaky_relu", "bn", "plain")


def bn_case(mode: str, x, gy, scale, bias, gmu, gvar, rows=slice(None),
            n_ranks: int = 1):
    """(y, mu, var, dx, dscale, dbias) of one train-mode BN of ``mode``
    on ``x[rows]`` (the recompute VJP's four modes, or ``plain``:
    ``models/common.BatchNorm`` without recompute, whose (mu, var) are its
    running statistics after one update from (0, 1)); the loss
    sum(y gy) + (mu gmu + var gvar) / n_ranks, so that the ranks' losses
    add up to the one process's."""
    from asvspoof2021_air_tpu_torch.models.common import BatchNorm
    from asvspoof2021_air_tpu_torch.ops import bn_relu_vjp as bv

    tx = torch.from_numpy(x[rows].copy()).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    if mode == "plain":
        bn = BatchNorm(x.shape[1]).train()
        with torch.no_grad():
            bn.weight.copy_(ts)
            bn.bias.copy_(tb)
        y = bn(tx)
        loss = (y * torch.from_numpy(gy[rows])).sum()
        loss.backward()
        mu = (bn.running_mean - 0.9 * 0.0) / 0.1
        var = (bn.running_var - 0.9) / 0.1
        return host((y, mu, var, tx.grad, bn.weight.grad, bn.bias.grad))
    fn = {"relu_bn": bv.relu_bn_train, "bn_relu": bv.bn_relu_train,
          "bn": bv.bn_train,
          "bn_leaky_relu": lambda *a, **k: bv.bn_leaky_relu_train(
              *a[:4], 0.1, **k)}[mode]
    y, mu, var = fn(tx, ts, tb, 1e-5)
    loss = ((y * torch.from_numpy(gy[rows])).sum()
            + ((mu * torch.from_numpy(gmu)).sum()
               + (var * torch.from_numpy(gvar)).sum()) / n_ranks)
    loss.backward()
    return host((y, mu, var, tx.grad, ts.grad, tb.grad))


def write_feature_tree(root: str, part: str, n: int, seed: int) -> None:
    """``n`` labeled LFCC .npy files of the ASVspoof 2019 LA layout."""
    g = np.random.default_rng(seed)
    d = os.path.join(root, part, "LFCC")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        label = "spoof" if i % 2 else "bonafide"
        tag = "A01" if i % 2 else "-"
        feat = g.standard_normal((T - 3 + 7 * (i % 3), F)).astype(np.float32)
        feat += 0.5 * (i % 2)
        np.save(os.path.join(d, f"{i:06d}_LA_X_{i:04d}_{tag}_{label}.npy"),
                feat)


# ---------------------------------------------------------------- ranks


def run_data_parallel(rank: int, world: int, out_dir: str, start: dict,
                      ens_start: dict, lcnn_start: dict,
                      feats_root: str) -> dict:
    """Every 2-rank check of the single-system path, in one spawn."""
    from asvspoof2021_air_tpu_torch.data.datasets import (
        ASVspoof2019FeatureDataset)
    from asvspoof2021_air_tpu_torch.ops.bn_relu_vjp import batch_norm_group
    from asvspoof2021_air_tpu_torch.parallel import (
        host_shard_range, initialize_distributed, make_global_batch,
        make_mesh, shard_batch)
    from asvspoof2021_air_tpu_torch.parallel.mesh import batch_sharding
    from asvspoof2021_air_tpu_torch.scoring import (
        make_score_fn, score_to_file)
    from asvspoof2021_air_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from asvspoof2021_air_tpu_torch.train.ensemble import ensemble_mesh
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
    from asvspoof2021_air_tpu_torch.train.loop import setup_training, train
    from asvspoof2021_air_tpu_torch.train.steps import make_multi_step
    from asvspoof2021_air_tpu_torch.ops.augment import ChannelAugmenter

    out: dict = {}
    initialize_distributed(device="cpu")       # a no-op: the group exists
    mesh = make_mesh("cpu")
    group = mesh.group()
    rows = batch_sharding(mesh)(B)

    # ---- sharding helpers at W = 2 ----
    glob = {"x": np.arange(B * 3).reshape(B, 3), "y": np.arange(B)}
    local = shard_batch(glob, mesh)
    stacked = shard_batch({"x": np.stack([glob["x"]] * 2)}, mesh,
                          batch_axis=1)
    out["shard"] = dict(host_range=host_shard_range(100),
                        host_range_16=host_shard_range(B), rows=rows,
                        x=local["x"], y=local["y"], stacked=stacked["x"],
                        global_batch=host(make_global_batch(local, mesh)))

    # ---- the BN modes across the ranks ----
    bn = bn_inputs()
    with batch_norm_group(group):
        out["bn"] = {m: bn_case(m, *bn, rows=rows, n_ranks=world)
                     for m in BN_MODES}

    # ---- the data-parallel ECAPA step from features, 2 steps ----
    batches = feature_batches(3)
    cfg = config()
    _, _, st, step, _ = setup_training(cfg, SPE, device="cpu", mesh=mesh)
    st.load_state_dict(start)
    m1 = step(st, tensors(shard_batch(batches[0], mesh)))
    out["dp_step1"] = host(dict(metrics=m1, grads=grads(st),
                                running=running(st)))
    m2 = step(st, tensors(shard_batch(batches[1], mesh)))
    out["dp_end"] = host(dict(metrics=m2, state=st.state_dict()))

    # ---- checkpoint: rank 0 saves, both restore and take one step ----
    path = os.path.join(out_dir, "dp.pt")
    if rank == 0:
        save_checkpoint(path, st)
    dist.barrier()
    _, _, back, _, _ = setup_training(cfg, SPE, device="cpu", mesh=mesh)
    restore_checkpoint(path, back)
    third = tensors(shard_batch(batches[2], mesh))
    m_back = step(back, third)
    m_cont = step(st, third)
    a, b = back.state_dict(), st.state_dict()
    out["resume_equal"] = (
        all(torch.equal(a["model"][k], v) for k, v in b["model"].items())
        and all(torch.equal(a["optimizer"][n][k], v)
                for n, s in b["optimizer"].items() for k, v in s.items())
        and torch.equal(a["loss_module"]["center"],
                        b["loss_module"]["center"])
        and all(torch.equal(m_back[k], m_cont[k]) for k in m_cont)
        and a["step"] == b["step"] == 3)

    # ---- a CUDA graph captures NCCL's collectives only: over gloo the
    # K-step graph is refused by name ----
    from asvspoof2021_air_tpu_torch.train import steps as steps_mod

    try:
        steps_mod._check_capturable_groups(step, 2)
        out["gloo_capture_refused"] = ""
    except ValueError as e:
        out["gloo_capture_refused"] = str(e)

    # ---- K = 2 steps per call (a loop on the CPU) vs 2 single steps ----
    multi = make_multi_step(step, 2)
    two = [tensors(shard_batch(b_, mesh)) for b_ in batches[:2]]
    st.load_state_dict(start)
    mk = multi(st, {k: torch.stack([b_[k] for b_ in two]) for k in two[0]})
    after_k = st.state_dict()
    st.load_state_dict(start)
    m_single = [step(st, b_) for b_ in two]
    after_1 = st.state_dict()
    out["multi_equal"] = (
        all(torch.equal(after_k["model"][k], v)
            for k, v in after_1["model"].items())
        and all(torch.equal(mk[k][i], m_single[i][k])
                for k in mk for i in range(2)))

    # ---- on the fly with the channel augmenter: the draws global ----
    fe = OnDeviceFrontend(feat_len=T, augmenter=ChannelAugmenter(
        device="cpu"), device="cpu")
    otf = dataclasses.replace(cfg, on_the_fly=True, on_device_aug=True)
    _, _, st, step, _ = setup_training(otf, SPE, frontend=fe, device="cpu",
                                       mesh=mesh)
    st.load_state_dict(start)
    m = step(st, tensors(shard_batch(wave_batch(length=fe.min_samples()),
                                     mesh)), rng=11,
             frontend_params=fe.params)
    out["otf"] = host(dict(metrics=m, grads=grads(st), running=running(st)))

    # ---- on the fly without the augmenter (LFCC alone), for JAX's step ----
    plain = dataclasses.replace(cfg, on_the_fly=True)
    fe = OnDeviceFrontend(feat_len=T, device="cpu")
    _, _, st, step, _ = setup_training(plain, SPE, frontend=fe,
                                       device="cpu", mesh=mesh)
    st.load_state_dict(start)
    m = step(st, tensors(shard_batch(wave_batch(length=fe.min_samples()),
                                     mesh)))
    out["otf_lfcc"] = host(dict(metrics=m, state=st.state_dict()))

    # ---- LCNN, whose dropout draws are sliced too ----
    lcnn = config(model="lcnn", add_loss="iso_sq")
    _, _, st, step, _ = setup_training(lcnn, SPE, device="cpu", mesh=mesh)
    st.load_state_dict(lcnn_start)
    m = step(st, tensors(shard_batch(batches[0], mesh)), rng=5)
    out["lcnn"] = host(dict(metrics=m, grads=grads(st), running=running(st)))

    # ---- sharded scoring of 2 B + 3 items: the last batch ragged ----
    fn = make_score_fn(start["model"], model_scale=SCALE, device="cpu")
    ds = ASVspoof2019FeatureDataset("LA", feats_root, "dev")
    score_to_file(fn, ds, os.path.join(out_dir, "sharded.txt"), True,
                  batch_size=B, feat_len=T, shard=mesh)

    # ---- member-parallel M = 2 over the 2 ranks ----
    ens = dataclasses.replace(cfg, ensemble=2)
    emesh = ensemble_mesh(2, "cpu")
    _, _, est, estep, _ = setup_training(ens, SPE, device="cpu", mesh=emesh)
    est.load_state_dict(ens_start)
    m = estep(est, tensors(batches[0]))
    out["member"] = host(dict(metrics=m, ids=est.member_ids,
                              state=est.state_dict()["members"]))

    # ---- train() over the mesh: 2 epochs, then auto_resume to a third
    # (every rank loads rank 0's checkpoint) ----
    run = os.path.join(out_dir, "run")
    c = config(path_to_features=feats_root, num_epochs=2, ratio=1.0,
               auto_resume=True, out_fold=run)
    summary, final = train(c, device="cpu", return_state=True)
    out["train"] = host(dict(summary=summary, state=final.state_dict()))
    summary3, final3 = train(dataclasses.replace(c, num_epochs=3),
                             device="cpu", return_state=True)
    out["train3"] = host(dict(summary=summary3, state=final3.state_dict()))

    # ---- train() of a 2-member ensemble: one member a rank ----
    c = config(path_to_features=feats_root, num_epochs=1, ratio=1.0,
               ensemble=2, out_fold=os.path.join(out_dir, "ens_run"))
    summary, final = train(c, device="cpu", return_state=True)
    out["ens_train"] = host(dict(summary=summary, ids=final.member_ids,
                                 members=final.state_dict()["members"]))
    return out


def run_member_data(rank: int, world: int, out_dir: str, start: dict,
                    feats_root: str, n_steps: int = 2) -> dict:
    """The 2 x 2 member x data ensemble step from features, ``n_steps``
    steps from the members of ``start``; then train() of a 2-member
    ensemble over the 4 ranks (the member x data mesh), one epoch and an
    auto_resume to a second."""
    from asvspoof2021_air_tpu_torch.train.ensemble import member_data_mesh
    from asvspoof2021_air_tpu_torch.train.loop import setup_training, train

    mesh = member_data_mesh(2, 2, "cpu")
    cfg = config(ensemble=2)
    _, _, st, step, _ = setup_training(cfg, SPE, device="cpu", mesh=mesh)
    st.load_state_dict(start)
    batches = feature_batches(n_steps, seed=9)
    metrics = [step(st, tensors({k: v[mesh.index("data") * B // 2:
                                      (mesh.index("data") + 1) * B // 2]
                                 for k, v in b.items()}))
               for b in batches]
    c = config(path_to_features=feats_root, num_epochs=1, ratio=1.0,
               ensemble=2, auto_resume=True,
               out_fold=os.path.join(out_dir, "run"))
    train(c, device="cpu")
    summary, final = train(dataclasses.replace(c, num_epochs=2),
                           device="cpu", return_state=True)
    return host(dict(coords=(mesh.index("model"), mesh.index("data")),
                     ids=st.member_ids, metrics=metrics,
                     state=st.state_dict()["members"],
                     train=dict(summary=summary, ids=final.member_ids,
                                members=final.state_dict()["members"])))


def fused_chain_state(start: dict = None):
    """The train state of ECAPA (C, SCALE, ENC) with ``fused_chain`` and
    OC-Softmax (ang_iso), loaded from ``start`` or, without it, drawn from
    a generator seeded 0."""
    from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
    from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
    from asvspoof2021_air_tpu_torch.train.state import (
        create_train_state, step_decay_schedule)

    gen = torch.Generator().manual_seed(0)
    st = create_train_state(
        ECAPA_TDNN(C=C, model_scale=SCALE, enc_dim=ENC, fused_pool=True,
                   fused_chain=True, generator=gen, device="cpu"),
        OCSoftmax(feat_dim=ENC, generator=gen, device="cpu"),
        step_decay_schedule(LR, 0.5, 30, SPE))
    if start is not None:
        st.load_state_dict(start)
    return st


def run_fused_chain(rank: int, world: int, out_dir: str, start: dict,
                    batch: dict) -> dict:
    """One data-parallel step of :func:`fused_chain_state` from ``start``
    on this rank's rows of the global ``batch``: the chain's BN moments
    across the ranks."""
    from asvspoof2021_air_tpu_torch.parallel import make_mesh, shard_batch
    from asvspoof2021_air_tpu_torch.train.steps import (
        StepConfig, make_train_step)

    mesh = make_mesh("cpu")
    st = fused_chain_state(start)
    step = make_train_step(StepConfig(add_loss="ang_iso"), device="cpu",
                           data_group=mesh.group())
    m = step(st, tensors(shard_batch(batch, mesh)))
    return host(dict(metrics=m, grads=grads(st), running=running(st)))
