"""Training from cached features: calls of the port's K-step CUDA graph.

Set-up builds the state and the step of the port's
``train.loop.setup_training`` (OC-Softmax, the configuration's compute
type, ``steps_per_call`` K, the recipe's batch and frames), loads the
benchmark's weights into it, and drives it through
``train.steps.make_multi_step(step, K)``: the first call runs its K steps
eagerly and captures them as one CUDA graph. Set-up then replays the
graph FIRSTS times, each from the start state, put back in place where the
graph reads it (the weights and BN's statistics, the centre, the
optimizers' moments and counts, the step), on K batches of the pool that
begin at another batch; the last begins at the first batch and is the
run's first K steps. The window goes on replaying the same object on the
pool's next stacks in turn, and ends on a synchronise.

``correct`` follows those replays with the plain reference from the same
weights and batches: the first step's two losses of each, OC-Softmax's
and the logits' cross-entropy (the forward at the start weights, on
FIRSTS batches); and of the last, each step's loss,
Adam's first moment after the K steps and the parameters' change over
them, each leaf's norm against the reference's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench.harness import inputs
from portbench.reference import common

UNIT = "step"
FIRSTS = 8            # replays from the start state
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone, and its change is not compared
ROUND_OFF_SHARE = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves) -> Dict[str, float]:
    """|got - ref| / max(ref, the median leaf's ref) of each of ``leaves``."""
    leaves = list(leaves)
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def compare(prog: dict, ref: dict, params0: Dict[str, torch.Tensor],
            detail: bool = False) -> dict:
    """The numbers of a program's (or a stand-in's) replays against the
    reference's: ``loss1_gap``, the root mean square of the first step's
    relative gaps of both losses over the replays (the forward alone, on as
    many batches); of the replay of the first stack, ``loss_gap_mean`` (the mean
    of the K steps' relative loss gaps), ``moment_gap_median`` (Adam's
    first moment after the K steps, by the median leaf), ``change_gap``
    and ``change_gap_median`` (the parameters' change over the K steps, by
    the worst and the median leaf). With ``detail``, the five worst leaves
    of the moment and the change with their two norms, and both sides'
    losses."""
    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]
    first = rel(prog["loss1"], ref["loss1"]) + rel(prog["base1"],
                                                    ref["base1"])
    steps = rel(prog["losses"], ref["losses"])
    raw = _norms(ref["grads"])
    med = float(np.median(list(raw.values())))
    moved = [k for k in raw if raw[k] >= ROUND_OFF_SHARE * med]
    m_prog, m_ref = _norms(prog["moments"]), _norms(ref["moments"])
    d_prog = _norms({k: prog["params"][k] - params0[k] for k in moved})
    d_ref = _norms({k: ref["params"][k] - params0[k] for k in moved})
    moment, change = leaf_gaps(m_prog, m_ref, m_ref), leaf_gaps(
        d_prog, d_ref, moved)
    out = {"loss1_gap": float(np.sqrt(np.mean(np.square(first)))),
           "loss_gap_mean": float(np.mean(steps)),
           "moment_gap_median": float(np.median(list(moment.values()))),
           "change_gap": max(change.values()),
           "change_gap_median": float(np.median(list(change.values())))}
    if detail:
        worst = lambda gaps, a, b: [
            [k, gaps[k], a[k], b[k]] for k in sorted(
                gaps, key=lambda k: -gaps[k])[:5]]
        out["worst_moment"] = worst(moment, m_prog, m_ref)
        out["worst_change"] = worst(change, d_prog, d_ref)
        out["losses"] = [prog["losses"], ref["losses"]]
        out["loss1"] = [prog["loss1"], ref["loss1"]]
        out["base1"] = [prog["base1"], ref["base1"]]
    return out


class Task:
    def __init__(self, cell, seed: int, device: torch.device,
                 weights: Dict[str, torch.Tensor]):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.weights = weights
        self.K, self.batch = self.traffic["steps_per_call"], \
            self.traffic["batch"]
        self.first: Optional[dict] = None
        self.calls = 0

    # ---- the program ------------------------------------------------------

    def stack(self, j: int) -> dict:
        S = self.pool["feat"].shape[0]
        return {"feat": self.pool["feat"][j % S],
                "label": self.pool["label"][j % S]}

    def setup(self) -> None:
        from asvspoof2021_air_tpu_torch.train.loop import (
            TrainConfig, setup_training)
        from asvspoof2021_air_tpu_torch.train.steps import make_multi_step

        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.pool = inputs.feature_pool(tr, cfg["feat_dim"], self.seed, dev)
        lc, oc = cfg["loss"], cfg["optimizer"]
        extra = ({"C": cfg["channels"], "model_scale": cfg["scale"]}
                 if cfg["port_model"] == "ecapa" else {})
        conf = TrainConfig(
            model=cfg["port_model"], add_loss="ang_iso",
            compute_dtype=cfg["compute_dtype"], steps_per_call=self.K,
            batch_size=self.batch, feat_len=cfg["feat_len"],
            feat_dim=cfg["feat_dim"], enc_dim=cfg["embedding"],
            r_real=lc["r_real"], r_fake=lc["r_fake"], alpha=lc["alpha"],
            lr=oc["lr"], beta_1=oc["betas"][0], beta_2=oc["betas"][1],
            eps=oc["eps"], **extra)
        _m, _l, state, step, _e = setup_training(
            conf, tr["steps_per_epoch"], device=dev)
        state.model.load_state_dict(
            {k: v for k, v in self.weights.items()
             if not k.startswith("loss.")})
        with torch.no_grad():
            state.loss_module.center.copy_(self.weights["loss.center"])
        self.state = state
        self.start = {k: v.detach().clone() for k, v in
                      state.model.state_dict().items()}
        self.params0 = {k: v.detach().clone() for k, v in self.trained()}
        self.multi = make_multi_step(step, self.K)
        self.feed(self.stack(0))          # eager steps, then the capture
        loss1, base1 = {}, {}
        for b in reversed(self.firsts()):
            self.restart()
            out = self.feed(self.stack_from(b))
            loss1[b], base1[b] = out["total_loss"][0], out["base_loss"][0]
        self.first = {
            "loss1": [float(loss1[b]) for b in self.firsts()],
            "base1": [float(base1[b]) for b in self.firsts()],
            "losses": [float(v) for v in self.last["total_loss"].float()],
            "moments": self._moments(),
            "params": {k: v.detach().clone() for k, v in self.trained()}}
        self.calls = 1                    # the window: the next stacks
        self.sync()

    def firsts(self) -> list:
        """The pool's batches that the replays from the start state begin
        at, evenly spaced from the first."""
        P = self.traffic["pool_batches"]
        return list(range(0, P, max(1, P // FIRSTS)))[:FIRSTS]

    def stack_from(self, b: int) -> dict:
        """The pool's K batches from batch ``b`` on, wrapping."""
        P, K = self.traffic["pool_batches"], self.K
        idx = [(b + i) % P for i in range(K)]
        return {k: v.flatten(0, 1)[idx] for k, v in self.pool.items()}

    def restart(self) -> None:
        """The state back at its start, in place: the model's weights and
        buffers, the centre, the optimizers' moments and counts, the
        step."""
        st = self.state
        with torch.no_grad():
            st.model.load_state_dict(self.start)
            st.loss_module.center.copy_(self.weights["loss.center"])
            for opt in st.optimizers():
                for slot in opt.state.values():
                    for v in slot.values():
                        if torch.is_tensor(v):
                            v.zero_()
        st.step = 0

    def trained(self):
        """(name, parameter) of the model and the loss module, by the
        reference's names."""
        st = self.state
        yield from st.model.named_parameters()
        for k, v in st.loss_module.named_parameters():
            yield "loss." + k, v

    def _moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment of each model parameter (zero where it holds
        none)."""
        st = self.state
        return {k: st.optimizer.state.get(p, {}).get(
            "exp_avg", torch.zeros_like(p)).detach().clone()
            for k, p in st.model.named_parameters()}

    def feed(self, stack: dict) -> dict:
        """One call of the K-step graph on ``stack``."""
        self.last = self.multi(self.state, stack, rng=self.seed,
                               adv_gate=0.0)
        return self.last

    def call(self, j: int) -> dict:
        self.calls += 1
        return self.feed(self.stack(j))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run(self, seconds: Optional[float] = None,
            count: Optional[int] = None) -> dict:
        """Calls of the K-step graph for ``seconds`` or ``count`` calls,
        ended by a synchronise."""
        self.sync()
        t0 = time.perf_counter()
        i = 0
        while (count is None or i < count) and (
                seconds is None or time.perf_counter() - t0 < seconds):
            self.call(self.calls)
            i += 1
        self.sync()
        t1 = time.perf_counter()
        return {"t0": t0, "seconds": t1 - t0, "units": i * self.K,
                "utterances": i * self.K * self.batch}

    def end_to_end(self, window: dict) -> Dict[str, float]:
        return {"train_utt_per_s": window["utterances"] / window["seconds"]}

    def model_flops(self, window: dict) -> float:
        return 3 * window["utterances"] * self.cell.config_module.forward_flops(
            self.cfg, self.cfg["feat_len"])

    def kernel_work(self) -> dict:
        return self.cell.config_module.kernel_work(self.cfg, self.batch,
                                                   train=True)

    def failed(self) -> int:
        """Utterances of the last call's steps whose loss is not finite."""
        loss = self.last["total_loss"].float().cpu()
        return int((~torch.isfinite(loss)).sum()) * self.batch

    def release(self) -> None:
        self.multi = self.state = self.last = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correct ----------------------------------------------------------

    def reference(self, prec: Optional[str] = None,
                  rows: Optional[slice] = None, rate: float = 1.0) -> dict:
        """The plain reference from the benchmark's weights, in float32 with
        TF32 off or with ``prec``'s operands, on ``rows`` of each batch and
        at ``rate`` times the configured learning rate (a fault): the first
        step's two losses on the first batch of each replay, and K steps on
        the pool's first stack."""
        common.full_f32()
        cfg, dev = self.cfg, self.device
        mod = self.cell.config_module
        rows = slice(None) if rows is None else rows

        def batch(stack, i):
            return {k: v[i].to(dev)[rows] for k, v in stack.items()}

        def noise(i):
            z = mod.train_noise(cfg, self.seed, i, self.batch,
                                cfg["feat_len"], dev)
            return None if z is None else z[rows]

        def forward(p, feats, train, z):
            return mod.reference.forward(p, feats, train, z, cfg, prec)

        params = {k: v.to(dev) for k, v in self.params0.items()}
        backbone = [k for k in params if not k.startswith("loss.")]
        opt = dict(cfg["optimizer"], lr=rate * cfg["optimizer"]["lr"])
        stack = self.stack(0)
        out = common.train_steps(forward, params,
                                 [batch(stack, i) for i in range(self.K)],
                                 cfg["loss"], opt, backbone,
                                 [noise(i) for i in range(self.K)])
        out["loss1"], out["base1"] = common.losses_at(
            forward, params, [batch(self.stack_from(b), 0)
                              for b in self.firsts()], cfg["loss"], noise(0))
        return out

    def numbers(self, reference: Optional[dict] = None) -> Dict[str, float]:
        ref = self.reference() if reference is None else reference
        return compare(self.first, ref, self.params0)
