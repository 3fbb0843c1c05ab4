"""Model summary: the parameter table and the output shapes of a module.

Counterpart of the JAX package's ``models/summary.py`` (``parameter_table``,
``summarize``) for an ``nn.Module`` already built: the rows are
``named_parameters`` (the reference's names; BN running statistics are
buffers, as flax keeps them outside ``params``), so the counts equal the
JAX model's for every family.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn


def parameter_table(model: nn.Module) -> List[Tuple[str, tuple, int]]:
    """(name, shape, size) of each parameter of ``model``."""
    return [(name, tuple(p.shape), p.numel())
            for name, p in model.named_parameters()]


def summarize(model: nn.Module, example_input, train: bool = False,
              print_fn=print) -> Dict[str, Any]:
    """Run ``model`` once on ``example_input`` (in train mode with
    ``train``; its BN statistics and mode are restored afterwards) and print
    a parameter summary. Returns {"n_params", "n_bytes", "output_shapes",
    "rows"}."""
    was_training = model.training
    saved = [b.detach().clone() for b in model.buffers()]
    model.train(train)
    try:
        with torch.no_grad():
            out = model(example_input)
    finally:
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)
        model.train(was_training)
    outputs = out if isinstance(out, (tuple, list)) else (out,)

    rows = parameter_table(model)
    n_params = sum(r[2] for r in rows)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    width = max((len(r[0]) for r in rows), default=20)
    print_fn("-" * (width + 30))
    print_fn(f"{'Parameter':<{width}}  {'Shape':>16}  {'Count':>10}")
    print_fn("=" * (width + 30))
    for name, shape, size in rows:
        print_fn(f"{name:<{width}}  {str(shape):>16}  {size:>10,}")
    print_fn("-" * (width + 30))
    print_fn(f"Total params: {n_params:,} ({n_bytes / 1e6:.2f} MB)")
    print_fn("Output shapes: " + ", ".join(str(tuple(o.shape))
                                           for o in outputs))
    return {"n_params": n_params, "n_bytes": n_bytes,
            "output_shapes": [tuple(o.shape) for o in outputs],
            "rows": rows}
