"""Checkpoints: the whole train state with ``torch.save``.

Counterpart of the JAX package's ``train/checkpoint.py`` (Orbax there): the
model, the loss module's center, the backbone's Adam state, the ADV_AUG
channel classifiers with their Adam states, and the step, in the form of
:meth:`TrainState.state_dict`; for an ensemble the shared step and every
member's (:meth:`EnsembleState.state_dict` of ``train/ensemble.py``), all
restored on a resume. The training loop writes
``<out>/checkpoint/<epoch>.pt`` and ``<out>/best.pt``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from asvspoof2021_air_tpu_torch.train.state import TrainState


def save_checkpoint(path: str, state) -> None:
    """Write ``state`` (a train state, or its ``state_dict``) to ``path``
    (parent directories made), atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state if isinstance(state, dict) else state.state_dict(),
               tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: Optional[TrainState] = None
                       ) -> Any:
    """The checkpoint dict at ``path``; with ``state``, load it there (onto
    the state's devices) and return the state."""
    data: Dict[str, Any] = torch.load(path, map_location="cpu",
                                      weights_only=True)
    if state is None:
        return data
    state.load_state_dict(data)
    return state
