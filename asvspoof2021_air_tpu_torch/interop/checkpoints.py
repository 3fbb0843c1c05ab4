"""Load a system trained elsewhere into the port.

- :func:`load_torch_checkpoint`: a reference PyTorch checkpoint (a whole
  pickled module or a state_dict) as a name -> tensor state_dict; the
  port's own copy of the JAX package's
  ``interop/torch_port.load_torch_checkpoint``. The port keeps the
  reference's state_dict names, so the result feeds
  ``ECAPA_TDNN.load_state_dict`` as it is (torch ``BatchNorm``'s
  ``num_batches_tracked`` counters, which the port's BatchNorm does not
  keep, are dropped).
- :func:`ecapa_from_state_dict`: the eval-mode ``ECAPA_TDNN`` those weights
  describe, its widths read from the weights.

A JAX ``TrainState`` checkpoint is converted where JAX is installed, by
``tools/jax_checkpoint_to_torch.py``, into the port's ``best.pt`` and
``args.json``; the port itself reads only ``.pt`` files.
"""

from __future__ import annotations

from typing import Dict

import torch

from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict (CPU tensors) of a checkpoint holding a whole pickled
    module or a state_dict. A pickled module is unpickled with
    ``weights_only=False``, which runs the file's code: load only trusted
    files, and have the module's classes importable."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: v.detach().cpu() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def ecapa_from_state_dict(sd: Dict[str, torch.Tensor], device="cuda"
                          ) -> ECAPA_TDNN:
    """An eval-mode ``ECAPA_TDNN`` on ``device`` holding ``sd`` (strict
    names), with C, scale, n_out, n_feat and enc_dim read from the
    weights' shapes."""
    scale = 1 + sum(1 for k in sd if k.startswith("layer1.convs.")
                    and k.endswith(".weight"))
    model = ECAPA_TDNN(C=sd["conv1.weight"].shape[0], model_scale=scale,
                       n_out=sd["fc7.weight"].shape[0],
                       n_feat=sd["conv1.weight"].shape[1],
                       enc_dim=sd["fc6.weight"].shape[0], device=device)
    model.load_state_dict(sd)
    return model.eval()
