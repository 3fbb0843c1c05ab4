"""Profiling: spans, launch counters that count graph replays, the node
tables of the port's CUDA graphs, the trace exporter and step timing.

Counterpart of the JAX package's ``utils/profiling.py`` (``trace``,
``StepTimer``), and the port's own instrumentation:

- :func:`span` names a stretch of the program ``asv.<layer>[.<part>]``.
  It records only while a ``torch.profiler`` is active or while the port
  captures one of its CUDA graphs; otherwise it returns a shared no-op
  object, after two reads of a flag. A recording span opens a
  ``record_function`` range under the profiler (on the profiler's clock,
  beside the device's events) and, in a capture, notes the capture's
  frontier (the nodes the next one would depend on) at entry and exit. In
  a grad-enabled forward it also hooks the backward: ``<name>:bwd`` opens
  when the first of its outputs (:meth:`_Span.out`) has its gradient and
  closes when the first of its inputs has its gradient, or when the
  backward pass ends. A span's casts (:meth:`_Span.cast`) hook each cast
  alone, from its gradient to the end of its own backward node.
- :class:`Capture` is the bookkeeping of one graph capture: on exit, still
  inside the capture, it lists the graph's work nodes in creation order
  (kernels, memsets, memcpys; ``csrc/graph_nodes.cu``), each with its
  kernel's demangled name (None where libcuda gives none) and the
  innermost span, forward or ``:bwd``, open when the node was made. The
  :class:`GraphTable` goes into a registry (:func:`tables`). Hooks and
  counts launch nothing, so the captured graph has the nodes it has
  without them.
- :func:`count` adds to a named counter (:func:`counts`, :func:`reset`).
  A capture keeps the counters' change while it recorded, takes it back
  (the capture runs nothing), and :func:`replay` adds it on every replay:
  the counters count the launches that ran. What is counted while a
  ``torch.profiler`` records is also kept apart (``counts(traced=True)``):
  a profiled slice's own change.
- :func:`trace` captures a ``torch.profiler`` trace of the enclosed region
  into ``trace.json``, with the node tables of the graphs it saw in
  ``spans.json``; :class:`StepTimer` tracks steps/s and utterances/s,
  synchronizing with the card where the JAX timer blocks until the result
  is ready.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import itertools
import json
import os
import time
import weakref
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _ap

KINDS = ("kernel", "memset", "memcpy")

_capture: Optional["Capture"] = None    # the capture being recorded
_counts: Dict[str, int] = {}
_traced: Dict[str, int] = {}            # counted while a profiler recorded
_tables: Dict[int, "GraphTable"] = {}
# ids of the tables captured or replayed while a profiler recorded
_seen: set = set()
_ids = itertools.count(1)


# ---- counters ------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n
    if _ap._is_profiler_enabled:
        _traced[name] = _traced.get(name, 0) + n


def counts(traced: bool = False) -> Dict[str, int]:
    """Every counter's total since :func:`reset`; with ``traced`` the part
    counted while a ``torch.profiler`` recorded."""
    return dict(_traced if traced else _counts)


def reset() -> None:
    """Set every counter to zero."""
    _counts.clear()
    _traced.clear()


# ---- spans ---------------------------------------------------------------

class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def out(y):
        return y

    @staticmethod
    def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return t.to(dtype)


_OFF = _Off()


def span(name: str, inp=None):
    """The span ``name`` (``asv.<layer>[.<part>]``) as a context manager;
    ``inp``, a tensor or a tuple of them, is what its backward range closes
    on. It records only under an active ``torch.profiler`` or inside a
    :class:`Capture`."""
    if not (_ap._is_profiler_enabled or _capture is not None):
        return _OFF
    return _Span(name, inp)


class _Range:
    """One recorded range: a ``record_function`` range under the profiler
    and an open span of the capture being recorded."""

    __slots__ = ("rf", "cap", "entry")

    def __init__(self, name: str):
        self.rf = None
        if _ap._is_profiler_enabled:
            self.rf = _ap.record_function(name)
            self.rf.__enter__()
        self.cap = _capture
        self.entry = None if self.cap is None else self.cap.open(name)

    def close(self) -> None:
        if self.cap is not None:
            self.cap.close(self.entry)
            self.cap = None
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


def _tensors(ts):
    ts = ts if isinstance(ts, (tuple, list)) else (ts,)
    return [t for t in ts if isinstance(t, torch.Tensor) and t.requires_grad]


class _Backward:
    """``<name>:bwd``: opened by the first hook on an output's gradient,
    closed by the first on an input's, or at the end of the backward
    pass."""

    __slots__ = ("name", "range", "done")

    def __init__(self, name: str):
        self.name, self.range, self.done = name, None, False

    def open(self, *_) -> None:
        if self.range is None and not self.done:
            self.range = _Range(self.name)
            torch.autograd.Variable._execution_engine.queue_callback(
                self.close)

    def close(self, *_) -> None:
        if self.range is not None:
            self.range.close()
            self.range = None
            self.done = True


class _Span:
    """A recording span (see :func:`span`)."""

    __slots__ = ("name", "inp", "range")

    def __init__(self, name: str, inp):
        self.name, self.inp, self.range = name, inp, None

    def __enter__(self):
        self.range = _Range(self.name)
        return self

    def __exit__(self, *exc):
        self.range.close()
        return False

    def out(self, y):
        """``y`` (a tensor or a tuple of them), the span's output: in a
        grad-enabled forward its gradient opens ``<name>:bwd``, which the
        first of the span's inputs with a gradient closes (or the end of
        the backward pass, where no input takes one)."""
        outs = _tensors(y) if torch.is_grad_enabled() else []
        if outs:
            bwd = _Backward(self.name + ":bwd")
            for t in outs:
                t.register_hook(bwd.open)
            for t in _tensors(self.inp):
                t.register_hook(bwd.close)
        return y

    def cast(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``t.to(dtype)``; in a grad-enabled forward its own backward node
        is ``<name>:bwd``, from its gradient to the node's end."""
        y = t.to(dtype)
        if y is not t and torch.is_grad_enabled() and y.requires_grad:
            bwd = _Backward(self.name + ":bwd")
            y.register_hook(bwd.open)
            y.grad_fn.register_hook(bwd.close)
        return y


# ---- graph captures and their node tables --------------------------------

class GraphTable(NamedTuple):
    """The work nodes of one captured graph, in creation order: ``kinds``
    (of :data:`KINDS`), ``names`` (the kernel's demangled name, None for a
    memset, a memcpy or a kernel libcuda names not), ``spans`` (the
    innermost span open when the node was made, None outside every
    span), and ``counts``, the counters' change that each replay adds."""
    id: int
    owner: str
    kinds: List[str]
    names: List[Optional[str]]
    spans: List[Optional[str]]
    counts: Dict[str, int]

    def as_json(self) -> dict:
        return {"id": self.id, "owner": self.owner,
                "counts": self.counts,
                "nodes": [list(n) for n in zip(self.kinds, self.names,
                                               self.spans)]}


def tables() -> List[GraphTable]:
    """The node tables of the live captured graphs."""
    return list(_tables.values())


def _library():
    from asvspoof2021_air_tpu_torch.ops import _build
    return _build.library()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _frontier(stream: int) -> tuple:
    """The handles of the nodes that the next node captured on ``stream``
    would depend on (none where the stream is not capturing)."""
    lib, cap = _library(), 8
    while True:
        handles = (ctypes.c_ulonglong * cap)()
        n = ctypes.c_longlong()
        _check(lib.asv_capture_frontier(ctypes.c_void_p(stream), handles, cap,
                                        ctypes.byref(n)),
               "asv_capture_frontier")
        if n.value <= cap:
            return tuple(handles[:max(n.value, 0)])
        cap = n.value


def _node_table(stream: int):
    """(kinds, kernel names, owners, tops) of the graph being captured on
    ``stream``: its work nodes, child graphs flattened, with each one's
    index among the top-level nodes (``owners``), and the handles of the
    top-level nodes in creation order (``tops``)."""
    lib = _library()
    tops_cap, cap, names_cap = 0, 0, 0
    while True:
        tops = (ctypes.c_ulonglong * max(tops_cap, 1))()
        kinds = (ctypes.c_int * max(cap, 1))()
        owners = (ctypes.c_longlong * max(cap, 1))()
        buf = ctypes.create_string_buffer(max(names_cap, 1))
        n_tops, n, need = (ctypes.c_longlong() for _ in range(3))
        _check(lib.asv_capture_node_table(
            ctypes.c_void_p(stream), tops, tops_cap, kinds, owners, cap, buf,
            names_cap, ctypes.byref(n_tops), ctypes.byref(n),
            ctypes.byref(need)), "asv_capture_node_table")
        if (n_tops.value <= tops_cap and n.value <= cap
                and need.value <= names_cap):
            break
        tops_cap, cap, names_cap = n_tops.value, n.value, need.value
    names = buf.raw[:need.value].split(b"\0")[:n.value]
    return ([KINDS[k] for k in kinds[:n.value]],
            [s.decode() or None for s in names], list(owners[:n.value]),
            list(tops[:n_tops.value]))


class Capture:
    """The bookkeeping of one capture of a CUDA graph on ``stream``, used
    inside the capture:

        cap = profiling.Capture(side, "train_steps", owner=self)
        with torch.cuda.graph(graph, stream=side), cap:
            ...
        self.table = cap.table

    Made before the capture begins, it loads the native side. Inside, every
    span notes the capture's frontier (the nodes the next one would depend
    on) where it opens and closes; on exit each frontier's last node in
    creation order gives the node count there, the counters' change is
    taken back and the :class:`GraphTable` registered (dropped with
    ``owner``)."""

    def __init__(self, stream: torch.cuda.Stream, owner_name: str,
                 owner=None):
        self.stream = stream.cuda_stream
        self.owner_name, self.owner = owner_name, owner
        self.table: Optional[GraphTable] = None
        _frontier(self.stream)            # the library, outside the capture

    def __enter__(self):
        global _capture
        if _capture is not None:
            raise RuntimeError("a capture is already being recorded")
        self.open_ranges: List[tuple] = []
        self.changes: List[tuple] = [((), None)]  # (frontier, innermost)
        self.seq = itertools.count()
        self.before = (dict(_counts), dict(_traced))
        _capture = self
        return self

    def _innermost(self) -> Optional[str]:
        return self.open_ranges[-1][1] if self.open_ranges else None

    def open(self, name: str) -> tuple:
        entry = (next(self.seq), name)
        self.open_ranges.append(entry)
        self.changes.append((_frontier(self.stream), name))
        return entry

    def close(self, entry: tuple) -> None:
        self.open_ranges.remove(entry)
        self.changes.append((_frontier(self.stream), self._innermost()))

    def spans_of(self, tops: List[int], indices: List[int]
                 ) -> List[Optional[str]]:
        """The innermost span open when each top-level node of ``indices``
        was made: the last change at a node count of that index or less,
        the count at a change being one past its frontier's last node in
        ``tops`` (the top-level nodes' handles in creation order)."""
        where = {h: i for i, h in enumerate(tops)}
        at = list(itertools.accumulate(
            (max((where.get(h, -1) for h in frontier), default=-1) + 1
             for frontier, _ in self.changes), max))
        return [self.changes[bisect.bisect_right(at, i) - 1][1]
                for i in indices]

    def __exit__(self, exc_type, *exc):
        global _capture
        _capture = None
        after = dict(_counts)
        _counts.clear()
        _counts.update(self.before[0])
        _traced.clear()
        _traced.update(self.before[1])
        if exc_type is not None:
            return False
        kinds, names, owners, tops = _node_table(self.stream)
        spans = self.spans_of(tops, owners)
        delta = {k: v - self.before[0].get(k, 0) for k, v in after.items()
                 if v != self.before[0].get(k, 0)}
        self.table = GraphTable(next(_ids), self.owner_name, kinds, names,
                                spans, delta)
        _tables[self.table.id] = self.table
        if _ap._is_profiler_enabled:
            _seen.add(self.table.id)
        if self.owner is not None:
            weakref.finalize(self.owner, _tables.pop, self.table.id, None)
        return False


def drop(table: Optional[GraphTable]) -> None:
    """Take ``table`` (of a graph its owner no longer replays) out of the
    registry."""
    if table is not None:
        _tables.pop(table.id, None)


def replay(table: GraphTable):
    """Account one replay of ``table``'s graph, to wrap the replay: its
    counters' change is added, and under an active profiler the host span
    ``asv.graph_replay`` carries the table's id."""
    for k, v in table.counts.items():
        count(k, v)
    if not _ap._is_profiler_enabled:
        return _OFF
    _seen.add(table.id)
    return _ap.record_function("asv.graph_replay", str(table.id))


# ---- the exporter and the step timer -------------------------------------

@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region into ``<log_dir>/trace.json`` (open it
    in Perfetto or chrome://tracing), and write the node tables of the
    graphs captured or replayed in it to ``<log_dir>/spans.json``
    (``{"tables": [...]}``, each as :meth:`GraphTable.as_json`; a
    replay's ``asv.graph_replay`` range names its table's id):

        with profiling.trace("/tmp/trace"):
            for _ in range(10):
                metrics = train_step(state, batch)
    """
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()))
    _seen.clear()
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump({"tables": [_tables[i].as_json() for i in sorted(_seen)
                                  if i in _tables]}, f)


class StepTimer:
    """Windowed steps/s and utterances/s (host clock; a CUDA ``result``
    is waited for first, so the time is the card's)."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self._t0: Optional[float] = None
        self._steps = 0

    def tick(self, result: Optional[torch.Tensor] = None) -> Optional[dict]:
        """Call once per step; returns rate stats every ``window`` steps."""
        if result is not None and result.is_cuda:
            torch.cuda.synchronize(result.device)
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._steps = 0
            return None
        self._steps += 1
        if self._steps % self.window:
            return None
        dt = now - self._t0
        stats = {
            "steps_per_sec": self._steps / dt,
            "utt_per_sec": self._steps * self.batch_size / dt,
            "ms_per_step": 1000.0 * dt / self._steps,
        }
        self._t0 = now
        self._steps = 0
        return stats
