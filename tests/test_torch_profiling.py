"""The port's spans, graph node tables and replay-aware counters
(``utils/profiling.py``) on the CPU: the spans a train step and a scoring
call open under the profiler, the off path, backward attribution with a
fake capture frontier in place of ``csrc/graph_nodes.cu``, and replay
accounting with a fake CUDA graph. Tiny shapes, one torch thread."""

import contextlib
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from asvspoof2021_air_tpu_torch.losses.registry import build_loss
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.models.resnet import ResNet
from asvspoof2021_air_tpu_torch.scoring import build_scoring_model, score_rule
from asvspoof2021_air_tpu_torch.serving import stream
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend
from asvspoof2021_air_tpu_torch.train.state import create_train_state
from asvspoof2021_air_tpu_torch.train.steps import StepConfig, make_train_step
from asvspoof2021_air_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401

B, T, ENC, L = 8, 24, 16, 3200

# what portbench/metrics read, by the step that opens them
TRAIN_SPANS = {"asv.bn", "asv.bn:bwd", "asv.cast", "asv.cast:bwd",
               "asv.pool", "asv.pool:bwd", "asv.loss", "asv.loss:bwd",
               "asv.optimizer", "asv.trunk"}
SCORE_SPANS = {"asv.frontend", "asv.frontend.copy", "asv.trunk", "asv.pool",
               "asv.score_rule"}


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts and ends with no counts and no tables."""
    profiling.reset()
    yield
    profiling.reset()
    profiling._tables.clear()


def _model(family: str, dtype=None):
    gen = torch.Generator().manual_seed(0)
    if family == "ecapa":
        return ECAPA_TDNN(C=32, model_scale=4, enc_dim=ENC, device="cpu",
                          generator=gen, dtype=dtype)
    return ResNet(enc_dim=ENC, device="cpu", generator=gen, dtype=dtype)


def _train_step(family: str):
    """A train step on one batch of a tiny ``family`` model in bf16, as
    the benchmark trains (the casts run)."""
    model = _model(family, torch.bfloat16)
    state = create_train_state(model, build_loss("ocsoftmax", enc_dim=ENC,
                                                 device="cpu"),
                               lambda s: 5e-4)
    step = make_train_step(StepConfig(add_loss="ang_iso"), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"feat": torch.randn(B, T, 60, generator=g),
             "label": torch.arange(B) % 2}
    return lambda: step(state, batch, rng=3)


def _score_call(family: str):
    """The scoring entry of portbench's score_wave task on one batch of
    waveforms: front end, scoring model, scoring rule."""
    sd = _model(family).eval().state_dict()
    net = build_scoring_model(sd, family, dtype=torch.float32,
                              model_scale=4, device="cpu")
    loss = build_loss("ocsoftmax", enc_dim=ENC, device="cpu").eval()
    frontend = OnDeviceFrontend(feat_len=T, device="cpu")
    g = torch.Generator().manual_seed(2)
    wave = torch.randn(B, L, generator=g)
    length = torch.full((B,), L)

    def call():
        with torch.inference_mode():
            emb, logits = net(frontend({"wave": wave, "length": length}))
            return score_rule("ocsoftmax", emb, logits, loss)

    return call


@pytest.mark.parametrize("family", ["ecapa", "resnet"])
def test_a_step_and_a_scoring_call_open_every_read_span(family):
    train, score = _train_step(family), _score_call(family)
    want = {"train": TRAIN_SPANS | ({"asv.se", "asv.se:bwd"}
                                    if family == "ecapa" else set()),
            "score": SCORE_SPANS}
    for name, call in (("train", train), ("score", score)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        got = {e.name for e in prof.events() if e.name.startswith("asv.")}
        assert want[name] <= got, (name, sorted(want[name] - got))


def test_the_off_path_makes_no_record_function(monkeypatch):
    real = torch.autograd.profiler.record_function

    def refuse(name, *args, **kwargs):
        # torch.optim opens ranges of its own; the program's are asv.*
        if name.startswith("asv."):
            raise AssertionError(f"{name} recorded with no profiler or "
                                 f"capture")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("asv.a") is profiling.span("asv.b", torch.ones(1))
    _train_step("ecapa")()
    _score_call("resnet")()


class _Launch(torch.autograd.Function):
    """A stand-in kernel: its forward and its backward each make one node
    of the fake graph, named in ``made``, where they run in a capture."""

    made: list = []

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        _Launch.made_in_capture(name)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _Launch.made_in_capture(ctx.name + "'")
        return g.clone(), None

    @staticmethod
    def made_in_capture(name):
        if profiling._capture is not None:
            _Launch.made.append(name)


def _fake_native(monkeypatch):
    """The frontier and the table of ``csrc/graph_nodes.cu`` over the fake
    graph that :class:`_Launch` builds, one chain: node i's handle is i."""
    made = _Launch.made
    made.clear()
    monkeypatch.setattr(profiling, "_frontier",
                        lambda stream: (len(made) - 1,) if made else ())
    monkeypatch.setattr(profiling, "_node_table", lambda stream: (
        ["kernel"] * len(made), list(made), list(range(len(made))),
        list(range(len(made)))))
    return types.SimpleNamespace(cuda_stream=0)


def test_backward_attribution_orders_nested_spans(monkeypatch):
    side = _fake_native(monkeypatch)
    launch = _Launch.apply
    x = torch.ones(4, requires_grad=True)
    with profiling.Capture(side, "test") as cap:
        with profiling.span("asv.outer", x) as so:
            a = launch(x, "o1")
            with profiling.span("asv.cast") as sc:
                a = sc.cast(a, torch.float64)
            a = launch(a, "o2")
            with profiling.span("asv.inner", a) as si:
                b = si.out(launch(a, "i1"))
            c = so.out(launch(b, "o3"))
        with profiling.span("asv.trunk", x.detach()) as st:
            d = st.out(launch(c, "t1"))
        launch(d, "tail").sum().backward()
        with profiling.span("asv.optimizer"):
            launch(x.detach(), "opt")
        launch(x.detach(), "after")
    want = {"o1": "asv.outer", "o2": "asv.outer", "i1": "asv.inner",
            "o3": "asv.outer", "t1": "asv.trunk", "tail": None,
            # the backward in the reverse order
            "tail'": None, "t1'": "asv.trunk:bwd",
            "o3'": "asv.outer:bwd", "i1'": "asv.inner:bwd",
            # the cast's own node made none; o2' is outer's again
            "o2'": "asv.outer:bwd", "o1'": "asv.outer:bwd",
            "opt": "asv.optimizer", "after": None}
    table = cap.table
    assert table.names == ["o1", "o2", "i1", "o3", "t1", "tail", "tail'",
                           "t1'", "o3'", "i1'", "o2'", "o1'", "opt",
                           "after"]
    assert dict(zip(table.names, table.spans)) == want
    assert profiling.tables() == [table]
    assert profiling._capture is None


class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def _fake_cuda(monkeypatch):
    """torch.cuda's streams and graphs as the CPU can stand them in: no
    stream waits, a capture that runs its body once, a graph whose
    replay runs nothing."""
    side = types.SimpleNamespace(cuda_stream=0, wait_stream=lambda s: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: side)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: side)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, stream=None: contextlib.nullcontext())


def test_a_replay_adds_the_captures_counts(monkeypatch, tmp_path):
    _fake_native(monkeypatch)
    _fake_cuda(monkeypatch)

    def infer(batch):
        profiling.count("B3")
        return _Launch.apply(batch, "b3")

    scan = stream.CudaGraphScan(infer, torch.device("cpu"))
    stacked = torch.zeros(2, 3)
    scan(stacked)                 # 2 warm-up calls, the capture, a replay
    assert profiling.counts() == {"B3": 2 + 2}
    table = scan.table
    assert table.counts == {"B3": 2} and table.names == ["b3", "b3"]
    with profiling.trace(str(tmp_path)):
        scan(stacked)
        scan(stacked)
    assert profiling.counts() == {"B3": 2 + 3 * 2}
    assert profiling.counts(traced=True) == {"B3": 2 * 2}
    assert _FakeGraph.replays >= 3
    spans = json.load(open(tmp_path / "spans.json"))
    assert spans["tables"] == [table.as_json()]
    scan(torch.zeros(2, 5))       # a new shape: a new capture and table
    assert profiling.tables() == [scan.table] and scan.table.id != table.id


def test_the_front_end_counts_the_bytes_it_copies():
    fe = OnDeviceFrontend(feat_len=T, device="cpu")
    wave = torch.zeros(64, 100)
    fe._to_device(wave)
    assert profiling.counts() == {}          # on the CPU nothing is copied
    fe.device = torch.device("meta")
    fe._to_device(wave)
    fe._to_device(torch.zeros(64, dtype=torch.long))
    assert profiling.counts() == {"h2d_bytes": 64 * 100 * 4 + 64 * 8}
