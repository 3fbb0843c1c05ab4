"""Device resolution for the port's entry points.

The default device is the GPU. The CPU is used only when the caller asks
for it by name; a missing GPU is an error, never a silent fall-back.
"cuda" names the process's current card: under ``torchrun`` one process
runs on each GPU, and ``parallel/distributed.initialize_distributed``
makes ``cuda:LOCAL_RANK`` current, so every entry point of that process
lands there.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no GPU
    is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions (cuDNN runs f32 convolutions in
    TF32 by default, which keeps about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
