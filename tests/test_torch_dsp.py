"""Port DSP primitives (asvspoof2021_air_tpu_torch/ops/dsp.py) against the
JAX package's ops/dsp.py: constant builders exactly equal, array ops at
atol 1e-6 (f32 elementwise arithmetic in the same order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asvspoof2021_air_tpu.ops import dsp as jdsp
from asvspoof2021_air_tpu_torch.ops import dsp as tdsp


@pytest.mark.parametrize("name,args", [
    ("hamming_window", (320,)),
    ("hamming_window", (400, False)),
    ("dct_matrix", (20, "dct", "ortho")),
    ("dct_matrix", (20, "dct")),
    ("dct_matrix", (12, "idct", "ortho")),
    ("dct_matrix", (9, "dct1")),
    ("dct_matrix", (9, "idct1")),
    ("linear_filterbank", (512, 16000, 20)),
    ("linear_filterbank", (400, 8000, 13)),
])
def test_constant_builders_equal(name, args):
    want = getattr(jdsp, name)(*args)
    got = getattr(tdsp, name)(*args)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("win,n_fft", [(320, 512), (400, 512)])
def test_windowed_dft_matrices_equal(win, n_fft):
    for got, want in zip(tdsp.windowed_dft_matrices(win, n_fft),
                         jdsp.windowed_dft_matrices(win, n_fft)):
        np.testing.assert_array_equal(got, want)
    assert tdsp.num_frames(48000, 160) == jdsp.num_frames(48000, 160)
    assert tdsp.FLOAT32_EPS == jdsp.FLOAT32_EPS


def test_trimf_equal():
    x = np.linspace(-1.0, 5.0, 97)
    np.testing.assert_array_equal(tdsp.trimf(x, 0.0, 1.5, 4.0),
                                  jdsp.trimf(x, 0.0, 1.5, 4.0))


@pytest.mark.parametrize("L,win,hop", [(8000, 320, 160), (3210, 400, 200)])
def test_preemphasis_and_framing(L, win, hop):
    x = np.random.default_rng(0).standard_normal((2, L)).astype(np.float32)
    np.testing.assert_allclose(
        tdsp.preemphasis(torch.from_numpy(x)).numpy(),
        np.asarray(jdsp.preemphasis(jnp.asarray(x))), atol=1e-6)
    got = tdsp.frame_signal(torch.from_numpy(x), win, hop, 512).numpy()
    want = np.asarray(jdsp.frame_signal(jnp.asarray(x), win, hop, 512))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lengths", [None, [7, 12, 3]])
def test_delta_with_lengths(lengths):
    x = np.random.default_rng(1).standard_normal((3, 12, 5)).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    want = np.asarray(jdsp.delta(jnp.asarray(x), jl))
    got = tdsp.delta(torch.from_numpy(x), tl).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
