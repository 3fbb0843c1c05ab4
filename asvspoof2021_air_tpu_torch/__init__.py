"""PyTorch/CUDA port of the anti-spoofing system: the serving path
waveform (WAV or FLAC) -> LFCC -> ECAPA-TDNN -> OC-Softmax score file,
feature-file scoring over the 8 tasks with evaluation (EER, min-tDCF) and
score fusion, and ECAPA + OC-Softmax training on the fly.

The JAX package ``asvspoof2021_air_tpu`` is the reference this port is held
against; nothing here imports it or JAX. Every public entry point takes
``device=`` (default ``"cuda"``) and raises when no GPU is present unless
the caller asks for ``"cpu"``. Every Pallas kernel of the JAX package is
hand-written CUDA C++ for sm_90a (``csrc/``), each beside a plain PyTorch
version that runs for CPU tensors only.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # imported on first use, so that a host-only module of the package
    # (``cli.degrade``'s workers, ``data.augment_host``) loads without torch
    if name == "resolve_device":
        from asvspoof2021_air_tpu_torch._device import resolve_device
        return resolve_device
    raise AttributeError(name)
