"""Seeding and a permissive CLI boolean.

Counterpart of the JAX package's ``utils/seed.py``. The JAX package draws
its weights from ``jax.random`` keys; the port draws them from an explicit
torch generator, which :func:`setup_seed` returns.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def setup_seed(seed: int) -> torch.Generator:
    """Seed python's ``random``, numpy's global generator and torch's
    global generator, and return a CPU ``torch.Generator`` seeded with
    ``seed`` for the weights."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)


def str2bool(v) -> bool:
    """'yes'/'true'/'1'/... -> True, 'no'/'false'/'0'/... -> False."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("y", "yes", "t", "true", "on", "1"):
        return True
    if s in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {v!r}")
