"""Profiling and step timing.

Counterpart of the JAX package's ``utils/profiling.py``: ``trace`` captures
a ``torch.profiler`` trace of the enclosed region (host and, where there is
a card, device activity) and writes it as a Chrome trace; ``StepTimer``
tracks steps/s and utterances/s, synchronizing with the card where the JAX
timer blocks until the result is ready.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region into ``<log_dir>/trace.json`` (open it
    in Perfetto or chrome://tracing):

        with profiling.trace("/tmp/trace"):
            for _ in range(10):
                metrics = train_step(state, batch)
    """
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
