"""The port's STFT and Melspec front-ends and its mel filterbank against
the JAX package's, on the CPU, on seeded numpy waveforms with and
without padding (a zero tail after each utterance's length).

Tolerances: ``mel_filterbank`` within 1e-7 of JAX's (both are float64
numpy rounded to f32). STFT and Melspec: JAX computes the power as
(frames C)^2 + (frames S)^2 from f32 products; the port takes
``torch.fft.rfft``. Each bar is read in the test from JAX's own distance
to a float64 reference on the same input (numpy's float64 ``rfft`` of the
same frames and f32 window): the port within twice that distance of
JAX's output, and the port's own distance to float64 no larger than
JAX's. Readings at these seeds: JAX's STFT 1.0e-4 - 1.3e-4 from float64
(powers up to 390), its Melspec 4.7e-6 - 1.3e-5 (up to 33); the port's
own distance 0.48 - 0.70 of JAX's, the port to JAX 0.95 - 1.27 of it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.ops import dsp as jdsp
from asvspoof2021_air_tpu.ops.lfcc import Melspec as JMelspec
from asvspoof2021_air_tpu.ops.lfcc import STFT as JSTFT
from asvspoof2021_air_tpu_torch.ops import dsp
from asvspoof2021_air_tpu_torch.ops.lfcc import STFT, Melspec

B, L = 3, 12000


def waves(seed: int, padded: bool) -> np.ndarray:
    """(B, L) f32 noise-plus-tone waveforms; ``padded``: each row zero
    after a length of its own."""
    g = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    w = 0.1 * g.standard_normal((B, L)) + 0.2 * np.sin(
        2 * np.pi * g.uniform(100, 4000, (B, 1)) * t)
    if padded:
        for r, n in enumerate(g.integers(L // 3, L, B)):
            w[r, n:] = 0.0
    return w.astype(np.float32)


def stft_float64(w: np.ndarray) -> np.ndarray:
    """The STFT power in float64: pre-emphasis, the center-padded frames
    and the f32 periodic Hamming window, numpy's rfft at n_fft 512."""
    x = w.astype(np.float64)
    x = np.concatenate([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1]], axis=1)
    frames = dsp.frame_signal(torch.from_numpy(x), 320, 160, 512).numpy()
    z = np.fft.rfft(frames * dsp.hamming_window(320).astype(np.float64),
                    n=512)
    return z.real ** 2 + z.imag ** 2


def melspec_float64(w: np.ndarray) -> np.ndarray:
    """The Melspec in float64: reflect padding, the f32 periodic Hann
    window, numpy's rfft at 512, the f32 mel filterbank; (B, 128, T)."""
    x = np.pad(w.astype(np.float64), ((0, 0), (256, 256)), mode="reflect")
    T = 1 + (x.shape[1] - 512) // 128
    frames = np.stack([x[:, t * 128:t * 128 + 512] for t in range(T)], 1)
    window = np.hanning(513)[:-1].astype(np.float32).astype(np.float64)
    z = np.fft.rfft(frames * window, n=512)
    fb = dsp.mel_filterbank(512, 16000, 128).astype(np.float64)
    return np.transpose((z.real ** 2 + z.imag ** 2) @ fb, (0, 2, 1))


def check_by_jax_distance(port: np.ndarray, jax_out: np.ndarray,
                          ref: np.ndarray) -> None:
    d_jax = float(np.abs(jax_out - ref).max())
    d_port = float(np.abs(port - ref).max())
    assert d_jax > 0
    assert float(np.abs(port - jax_out).max()) <= 2 * d_jax
    assert d_port <= d_jax, (d_port, d_jax)


def test_mel_filterbank_equals_jax():
    for args in ((512, 16000, 128), (1024, 22050, 80, 20.0, 8000.0),
                 (400, 16000, 40, 0.0, None, True)):
        np.testing.assert_allclose(dsp.mel_filterbank(*args),
                                   jdsp.mel_filterbank(*args), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stft_equals_jax(seed, padded):
    w = waves(seed, padded)
    got = STFT(device="cpu")(torch.from_numpy(w)).numpy()
    want = np.asarray(jax.jit(JSTFT().__call__)(jnp.asarray(w)))
    assert got.shape == want.shape == (B, 1 + L // 160, 257)
    check_by_jax_distance(got, want, stft_float64(w))


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("seed", [0, 1])
def test_melspec_equals_jax(seed, padded):
    w = waves(seed, padded)
    got = Melspec(device="cpu")(torch.from_numpy(w)).numpy()
    want = np.asarray(jax.jit(JMelspec().__call__)(jnp.asarray(w)))
    assert got.shape == want.shape == (B, 128, 1 + L // 128)
    check_by_jax_distance(got, want, melspec_float64(w))


def test_front_ends_default_to_cuda_and_refuse_the_cpu(monkeypatch):
    """The device rule: STFT, Melspec, CQCC and the preprocess CLI's
    extractors default to the GPU and raise without one unless asked for
    the CPU."""
    from asvspoof2021_air_tpu_torch.cli.preprocess import build_extractor
    from asvspoof2021_air_tpu_torch.ops.cqcc import CQCC

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (STFT, Melspec, CQCC, lambda: build_extractor("LFCC"),
                 lambda: build_extractor("CQCC")):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert STFT(device="cpu").window.device.type == "cpu"
    assert build_extractor("Melspec", "cpu")[1] == 128
