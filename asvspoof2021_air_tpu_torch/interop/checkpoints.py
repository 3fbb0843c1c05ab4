"""Load a system trained elsewhere into the port.

- :func:`load_torch_checkpoint`: a reference PyTorch checkpoint (a whole
  pickled module or a state_dict) as a name -> tensor state_dict; the
  port's own copy of the JAX package's
  ``interop/torch_port.load_torch_checkpoint``. The port keeps the
  reference's state_dict names, so the result feeds
  ``ECAPA_TDNN.load_state_dict`` as it is (torch ``BatchNorm``'s
  ``num_batches_tracked`` counters, which the port's BatchNorm does not
  keep, are dropped).
- :func:`ecapa_from_state_dict`, :func:`resnet_from_state_dict`,
  :func:`lcnn_from_state_dict`, :func:`res2net_from_state_dict`,
  :func:`convnet_from_state_dict` and :func:`rawnet_from_state_dict`: the
  eval-mode model those weights describe, its widths read from the weights
  (LCNN's and ConvNet's input frequency dim is given: the head's width
  fixes only its product with ``feat_len``; RawNet2's arguments are given,
  its sinc bank having no weights).

A JAX ``TrainState`` checkpoint is converted where JAX is installed, by
``tools/jax_checkpoint_to_torch.py``, into the port's ``best.pt`` and
``args.json``; the port itself reads only ``.pt`` files.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.models.convnet import ConvNet
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.models.lcnn import LCNN
from asvspoof2021_air_tpu_torch.models.rawnet import RawNet
from asvspoof2021_air_tpu_torch.models.res2net import SERes2Net50
from asvspoof2021_air_tpu_torch.models.resnet import RESNET_CONFIGS, ResNet


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


def resnet_from_state_dict(sd: Dict[str, torch.Tensor],
                           dtype: Optional[torch.dtype] = None,
                           device="cuda") -> ResNet:
    """An eval-mode ``ResNet`` on ``device`` (compute ``dtype``) holding
    ``sd`` (strict names): its type from the blocks per stage and the
    bottleneck's ``conv3``, num_nodes, enc_dim and the classes from the
    weights' shapes."""
    device = resolve_device(device)
    blocks = [len({k.split(".")[1] for k in sd if k.startswith(f"layer{i}.")})
              for i in range(1, 5)]
    bottleneck = "layer1.0.conv3.weight" in sd
    kind = next(name for name, (layers, block) in RESNET_CONFIGS.items()
                if layers == blocks
                and (block.expansion == 4) == bottleneck)
    model = ResNet(num_nodes=sd["conv5.weight"].shape[2],
                   enc_dim=sd["fc.weight"].shape[0], resnet_type=kind,
                   nclasses=sd["fc_mu.weight"].shape[0], dtype=dtype,
                   device=device)
    model.load_state_dict(sd)
    return model.eval()


def lcnn_from_state_dict(sd: Dict[str, torch.Tensor], num_nodes: int = 60,
                         dtype: Optional[torch.dtype] = None,
                         device="cuda") -> LCNN:
    """An eval-mode ``LCNN`` on ``device`` (compute ``dtype``) holding
    ``sd`` (strict names) for ``num_nodes``-dim features: enc_dim, the
    classes and the head's ``feat_len`` (16 x its width in frames) from
    the weights' shapes."""
    device = resolve_device(device)
    width = sd["out.1.weight"].shape[1] // (32 * (num_nodes // 16))
    model = LCNN(num_nodes=num_nodes, enc_dim=sd["out.3.weight"].shape[0],
                 nclasses=sd["fc_mu.weight"].shape[0], feat_len=16 * width,
                 dtype=dtype, device=device)
    model.load_state_dict(sd)
    return model.eval()


def res2net_from_state_dict(sd: Dict[str, torch.Tensor], device="cuda"
                            ) -> SERes2Net50:
    """An eval-mode ``SERes2Net50`` on ``device`` holding ``sd`` (strict
    names; the classes from ``cls_layer``)."""
    device = resolve_device(device)
    model = SERes2Net50(num_classes=sd["cls_layer.weight"].shape[0],
                        device=device)
    model.load_state_dict(sd)
    return model.eval()


def convnet_from_state_dict(sd: Dict[str, torch.Tensor], feat_dim: int = 60,
                            device="cuda") -> ConvNet:
    """An eval-mode ``ConvNet`` on ``device`` holding ``sd`` (strict
    names): the variant from ``attention.att_weights``, ``layer5``'s rows,
    enc_dim, the classes and ``fc1``'s width from the weights' shapes."""
    device = resolve_device(device)
    attention = "attention.att_weights" in sd
    model = ConvNet(
        num_classes=sd["fc3.weight"].shape[0],
        num_nodes=sd["layer5.0.weight"].shape[2] if attention else 512,
        enc_dim=sd["fc2.weight"].shape[0], subband_attention=attention,
        feat_dim=feat_dim,
        flat=None if attention else sd["fc1.weight"].shape[1],
        device=device)
    model.load_state_dict(sd)
    return model.eval()


def rawnet_from_state_dict(sd: Dict[str, torch.Tensor],
                           rawnet_args: Optional[dict] = None,
                           device="cuda") -> RawNet:
    """An eval-mode ``RawNet`` at ``rawnet_args`` (the default arguments
    when None) on ``device`` holding ``sd`` (strict names)."""
    device = resolve_device(device)
    model = RawNet(d_args=rawnet_args, device=device)
    model.load_state_dict(sd)
    return model.eval()
