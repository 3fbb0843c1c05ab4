"""serving of the PyTorch/CUDA port."""

from asvspoof2021_air_tpu_torch.serving.ecapa_int8 import ecapa_apply_int8

__all__ = ["ecapa_apply_int8"]
