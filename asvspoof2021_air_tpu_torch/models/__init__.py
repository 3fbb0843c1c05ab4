"""Embedding model families of the PyTorch/CUDA port: ResNet18, LCNN,
ECAPA-TDNN, SE-Res2Net50, RawNet2, ConvNet, Subband, and the adversarial
channel classifier (the JAX package's ``models/__init__.py`` exports).

Every family takes (B, T, F) features (RawNet2: (B, L) waveforms) and
returns an (embedding, logits) pair; Subband returns its band embeddings.
"""

from asvspoof2021_air_tpu_torch.models.common import (
    MaxFeatureMap, SelfAttentionPooling)
from asvspoof2021_air_tpu_torch.models.resnet import RESNET_CONFIGS, ResNet
from asvspoof2021_air_tpu_torch.models.lcnn import LCNN
from asvspoof2021_air_tpu_torch.models.ecapa import ECAPA_TDNN
from asvspoof2021_air_tpu_torch.models.res2net import SERes2Net50
from asvspoof2021_air_tpu_torch.models.rawnet import (
    RAWNET2_DEFAULT_ARGS, RawNet)
from asvspoof2021_air_tpu_torch.models.convnet import ConvNet
from asvspoof2021_air_tpu_torch.models.subband import Subband
from asvspoof2021_air_tpu_torch.models.classifier import (
    ChannelClassifier, gradient_reversal)
from asvspoof2021_air_tpu_torch.models.registry import (
    MODEL_REGISTRY, build_model)

__all__ = [
    "MaxFeatureMap",
    "SelfAttentionPooling",
    "ResNet",
    "RESNET_CONFIGS",
    "LCNN",
    "ECAPA_TDNN",
    "SERes2Net50",
    "RawNet",
    "RAWNET2_DEFAULT_ARGS",
    "ConvNet",
    "Subband",
    "ChannelClassifier",
    "gradient_reversal",
    "build_model",
    "MODEL_REGISTRY",
]
