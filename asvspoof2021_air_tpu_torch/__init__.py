"""PyTorch/CUDA port of the anti-spoofing system, first slice: the serving
path waveform -> LFCC -> ECAPA-TDNN -> OC-Softmax score file.

The JAX package ``asvspoof2021_air_tpu`` is the reference this port is held
against; nothing here imports it or JAX. Every public entry point takes
``device=`` (default ``"cuda"``) and raises when no GPU is present unless
the caller asks for ``"cpu"``. The three Pallas kernels on the serving path
are hand-written CUDA C++ for sm_90a (``csrc/``), each beside a plain
PyTorch version that runs for CPU tensors only.
"""

from asvspoof2021_air_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
