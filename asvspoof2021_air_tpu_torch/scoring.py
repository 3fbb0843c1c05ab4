"""Cache-free scoring: raw-audio dataset -> on-device LFCC -> ECAPA serving
graph -> reference-format score file.

Counterpart of the JAX package's ``scoring.py`` ``score_rule`` and
``score_raw_to_file``. The file stores ``fname -score [bonafide|spoof]``
lines, where the score is -softmax(logits)[:, 0] by default and the loss
module's score (-cos) for OC-Softmax, so an OC-Softmax file stores +cos
(bona fide near +1). The feature-file scorer and its task router come with
a later slice.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from asvspoof2021_air_tpu_torch._device import resolve_device
from asvspoof2021_air_tpu_torch.data.pipeline import WaveformIterator
from asvspoof2021_air_tpu_torch.serving.ecapa_serving import ServingECAPA

LABEL_NAMES = {0: "bonafide", 1: "spoof"}


def score_rule(add_loss: Optional[str], emb: torch.Tensor,
               logits: torch.Tensor, loss_module=None) -> torch.Tensor:
    """Per-loss score: the OC-Softmax score output for ocsoftmax/ang_iso,
    else -softmax(logits)[:, 0]."""
    if add_loss in ("ocsoftmax", "ang_iso"):
        labels = torch.zeros((emb.shape[0],), dtype=torch.long,
                             device=emb.device)
        _loss, score = loss_module(emb, labels)
        return score
    if add_loss in ("p2sgrad", "amsoftmax", "isolate", "iso_sq"):
        raise NotImplementedError(
            f"the {add_loss} scoring rule comes with the port of the other "
            "losses (ROADMAP Queue A, the losses item)")
    return -torch.softmax(logits, dim=1)[:, 0]


def score_raw_to_file(
    state_dict,
    dataset,
    output_path: str,
    labeled: bool,
    frontend,
    loss_module=None,
    add_loss: Optional[str] = None,
    batch_size: int = 64,
    dtype: torch.dtype = torch.bfloat16,
    model_scale: int = 8,
    device="cuda",
) -> str:
    """Score every utterance of ``dataset`` through ``frontend`` (an
    :class:`~asvspoof2021_air_tpu_torch.train.frontend.OnDeviceFrontend`)
    and the ECAPA serving graph built from ``state_dict``; write the score
    file and return its path."""
    dev = resolve_device(device)
    model = ServingECAPA(state_dict, dtype=dtype, model_scale=model_scale,
                         device=dev)
    if loss_module is not None:
        loss_module = loss_module.to(dev).eval()
    n = len(dataset)
    it = WaveformIterator(dataset, batch_size, frontend.min_samples(),
                          ratio=1.0, seed=0, shuffle=False,
                          steps_per_epoch=-(-n // batch_size))
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    written = 0
    with open(output_path, "w") as f, torch.inference_mode():
        for batch in it.epoch():
            feats = frontend({"wave": torch.from_numpy(batch["wave"]),
                              "length": torch.from_numpy(batch["length"])})
            emb, logits = model(feats)
            scores = score_rule(add_loss, emb, logits, loss_module)
            scores = scores.float().cpu().numpy()
            for j in range(len(scores)):
                if written >= n:
                    break
                if labeled:
                    key = LABEL_NAMES[int(batch["label"][j])]
                    f.write(f"{batch['fname'][j]} {-scores[j]} {key}\n")
                else:
                    f.write(f"{batch['fname'][j]} {-scores[j]}\n")
                written += 1
    return output_path
