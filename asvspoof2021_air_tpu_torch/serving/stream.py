"""Scanned multi-batch scoring: K batches in one dispatch.

Counterpart of the JAX package's ``serving/stream.py``
``make_scanned_infer``, which runs a per-batch scorer over K stacked
batches in one ``lax.scan`` so that K batches cost one dispatch. On the
GPU the analogue is a CUDA graph: the scorer's K calls are captured once
per input shape and type, and each later call copies the stacked batches
into the graph's input and replays it, one launch of the graph for the
K batches' kernels. On the CPU the runner is a plain loop over the K
batches.

The capture records the graph's node table (``utils/profiling.Capture``),
and each replay adds the launches counted in the capture to the kernels'
counters (``utils/profiling.count``): they count the launches that ran.
"""

from __future__ import annotations

from typing import Callable

import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.utils import profiling


class CudaGraphScan:
    """``run(stacked (K, ...)) -> (K, ...)``: ``infer_fn`` over the K
    leading slices, as one CUDA graph replay."""

    def __init__(self, infer_fn: Callable, device: torch.device):
        self.infer_fn, self.device = infer_fn, device
        self.graph = None
        self.key = None
        self.table = None

    def _capture(self, stacked: torch.Tensor) -> None:
        self.static_in = stacked.to(self.device, copy=True)
        # Warm up on a side stream first: library handles, plans and the
        # kernels' library are made outside the capture.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for batch in self.static_in:
                self.infer_fn(batch)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        profiling.drop(self.table)
        cap = profiling.Capture(side, "scan", owner=self)
        with torch.cuda.graph(self.graph, stream=side), cap:
            self.static_out = torch.stack(
                [self.infer_fn(batch) for batch in self.static_in])
        self.key, self.table = (tuple(stacked.shape), stacked.dtype), cap.table

    def __call__(self, stacked) -> torch.Tensor:
        stacked = torch.as_tensor(stacked)
        if self.key != (tuple(stacked.shape), stacked.dtype):
            self._capture(stacked)
        self.static_in.copy_(stacked)
        with profiling.replay(self.table):
            self.graph.replay()
        return self.static_out.clone()


def make_scanned_infer(infer_fn: Callable, device="cuda") -> Callable:
    """A runner applying ``infer_fn(batch) -> out`` to K stacked batches:
    it takes (K, *batch_shape) and returns the K outputs stacked, in
    order. On CUDA one graph replay runs the K calls; on the CPU they run
    in a loop."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return CudaGraphScan(infer_fn, dev)

    def run(stacked) -> torch.Tensor:
        return torch.stack([infer_fn(b) for b in torch.as_tensor(stacked)])

    return run
