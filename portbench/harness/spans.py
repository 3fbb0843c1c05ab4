"""What the readers of the program's spans and counters share
(``asvspoof2021_air_tpu_torch/utils/profiling.py``).

- **Training.** The K-step graph's replays have no host code, so their
  kernels are labelled by the graph's node table, which the program made
  at the capture: each node's kind (kernel, memset, memcpy), its kernel's
  name (None: any) and the innermost span open when it was made
  (``asv.bn``, ``asv.bn:bwd``, ...). :func:`train_split` finds, in the
  slice's device events sorted by start, each run that matches a table
  kind for kind and name for name (nodes of parallel branches may start
  in another order, within :data:`WINDOW` events), and adds each event's
  duration to its node's span.
- **Scoring.** The eager path's spans are host ranges on the profiler's
  clock: :func:`host_ms` sums their time by name, and :func:`idle_ms_under`
  the device's idle gaps whose middle falls inside a span of a name.

Against a program without these spans, tables or counters (a parent
commit) every function returns None."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def _profiling():
    from asvspoof2021_air_tpu_torch.utils import profiling
    return profiling


def kind_of(name: str) -> str:
    """The node kind of a device event's name, as the tables give it. A
    graph's memcpy and memset nodes run as copies or as CUDA's own
    kernels (``memcpy32_post``, ``memset32``)."""
    low = name[:6].lower()
    if low == "memcpy":
        return "memcpy"
    if low == "memset":
        return "memset"
    return "kernel"


# How far past the earliest unmatched event a node's event may start: the
# nodes of a graph's parallel branches (cuDNN's streams) start out of
# their creation order.
WINDOW = 64


def _match_at(kinds: List[str], names: List[str], at: int,
              table) -> Optional[List[int]]:
    """The events of one replay of ``table`` from event ``at`` on: for each
    node in creation order, the first unmatched event of its kind and name
    within ``WINDOW`` of the earliest unmatched one; the replay holds the
    events ``at`` .. ``at + len(table) - 1`` exactly. None where that
    fails."""
    n, taken, front, order = len(table.kinds), set(), at, []
    end = min(len(kinds), at + n)
    for k, name in zip(table.kinds, table.names):
        for i in range(front, min(end, front + WINDOW)):
            if i not in taken and kinds[i] == k and (
                    name is None or names[i] == name):
                break
        else:
            return None
        taken.add(i)
        order.append(i)
        while front in taken:
            front += 1
    return order if front == at + n else None


def match(events: Sequence[tuple], tables) -> Optional[dict]:
    """Runs of ``events`` ((name, start, end), sorted by start) that hold
    one replay of a table of ``tables`` (:func:`_match_at`): {"span_us":
    {span: us}, "labelled_us", "total_us", "replays"}; None where no run
    matched."""
    names = [e[0] for e in events]
    kinds = [kind_of(n) for n in names]
    span_us: Dict[str, float] = {}
    labelled = 0.0
    replays, i = 0, 0
    tables = [t for t in tables if t.kinds]
    while i < len(events):
        for t in tables:
            order = _match_at(kinds, names, i, t)
            if order is not None:
                for k, span in zip(order, t.spans):
                    if span is not None:
                        _, a, b = events[k]
                        span_us[span] = span_us.get(span, 0.0) + (b - a)
                        labelled += b - a
                i += len(t.kinds)
                replays += 1
                break
        else:
            i += 1
    if not replays:
        return None
    return {"span_us": span_us, "labelled_us": labelled,
            "total_us": sum(b - a for _, a, b in events),
            "replays": replays}


def train_split(ctx) -> Optional[dict]:
    """:func:`match` of the slice's device events against the program's
    node tables, once a context."""
    if not hasattr(ctx, "span_split"):
        tables = getattr(_profiling(), "tables", None)
        ctx.span_split = (match(sorted(ctx.slice.device, key=lambda e: e[1]),
                                tables())
                          if tables is not None and ctx.slice.device
                          else None)
    return ctx.span_split


def span_ms_per_unit(ctx, span: str, backward: bool = True
                     ) -> Optional[float]:
    """Device ms a unit of work (a step) under ``span`` and, with
    ``backward``, under ``span:bwd``; None where they hold nothing."""
    split = train_split(ctx)
    if split is None:
        return None
    us = split["span_us"].get(span, 0.0)
    if backward:
        us += split["span_us"].get(span + ":bwd", 0.0)
    return 1e-3 * us / ctx.slice.units if us > 0 else None


def covered_pct(ctx) -> Optional[float]:
    """The share of the slice's device time that a matched table labels."""
    split = train_split(ctx)
    if split is None or split["total_us"] <= 0:
        return None
    return 100.0 * split["labelled_us"] / split["total_us"]


def host_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Host ms a unit of work (a batch) in the program's spans ``names``;
    None where the slice holds none of them."""
    spans = [(a, b) for n, a, b in ctx.slice.host if n in names]
    if not spans:
        return None
    return 1e-3 * sum(b - a for a, b in spans) / ctx.slice.units


def idle_ms_under(ctx, name: str) -> Optional[float]:
    """Device idle ms a unit of work in the gaps between device events
    whose middle falls inside a host span ``name``; None where the slice
    holds no such span."""
    spans = [(a, b) for n, a, b in ctx.slice.host if n == name]
    if not spans or not ctx.slice.device:
        return None
    idle, reach = 0.0, None
    for _, a, b in sorted(ctx.slice.device, key=lambda e: e[1]):
        if reach is not None and a > reach:
            mid = 0.5 * (reach + a)
            if any(s <= mid <= e for s, e in spans):
                idle += a - reach
        reach = b if reach is None else max(reach, b)
    return 1e-3 * idle / ctx.slice.units


def traced_count_per_unit(ctx, counter: str) -> Optional[float]:
    """The change of the program's counter ``counter`` over the slice (what
    it counted while the profiler recorded), a unit of work."""
    counts = getattr(_profiling(), "counts", None)
    if counts is None:
        return None
    n = counts(traced=True).get(counter)
    return None if n is None else n / ctx.slice.units
