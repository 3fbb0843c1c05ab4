"""Port LFCC (plain LFCC and the B1 wrapper's plain version) against the JAX
package's LFCC and PallasLFCC (interpret mode), with and without lengths,
and at win 400 / hop 200 against the hop-rows layout (B1b's domain).

Tolerance atol 5e-4: the JAX package's own fused-vs-jnp LFCC bar
(tests/test_lfcc_pallas.py), since log10 near eps amplifies differences in
summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asvspoof2021_air_tpu.ops.lfcc import LFCC as JLFCC
from asvspoof2021_air_tpu.ops.lfcc import LFCCConfig as JConfig
from asvspoof2021_air_tpu.ops.lfcc_pallas import PallasLFCC
from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC, LFCCConfig
from asvspoof2021_air_tpu_torch.ops.lfcc_cuda import CudaLFCC

ATOL = 5e-4


def _wav(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("shape,lengths", [
    ((2, 48000), None),
    ((2, 48000), [32000, 48000]),
    ((3, 8000), None),
    ((3, 8000), [8000, 5120, 1601]),
])
def test_plain_and_fused_match_jax(shape, lengths):
    wav = _wav(shape, seed=shape[1] + (0 if lengths is None else 1))
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.tensor(lengths)
    want = np.asarray(JLFCC()(jnp.asarray(wav), jl))
    want_pallas = np.asarray(PallasLFCC(interpret=True)(jnp.asarray(wav), jl))

    plain = LFCC(device="cpu")(torch.from_numpy(wav), tl).numpy()
    fused = CudaLFCC(device="cpu")(torch.from_numpy(wav), tl).numpy()
    assert plain.shape == fused.shape == want.shape
    np.testing.assert_allclose(plain, want, atol=ATOL)
    np.testing.assert_allclose(fused, want_pallas, atol=ATOL)
    np.testing.assert_allclose(fused, want, atol=ATOL)


def test_hoprows_domain_win400_hop200():
    """win 400 / hop 200 has lcm(200, 128) / 200 = 16 phases, so the JAX
    package takes its hop-rows kernel there (_lfcc_kernel)."""
    wav = _wav((2, 12000), seed=5)
    lens = [12000, 7000]
    jcfg = JConfig(win_length=400, hop_length=200)
    want = np.asarray(PallasLFCC(jcfg, interpret=True, layout="hoprows")(
        jnp.asarray(wav), jnp.asarray(lens)))
    got = CudaLFCC(LFCCConfig(win_length=400, hop_length=200), device="cpu")(
        torch.from_numpy(wav), torch.tensor(lens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rejects_what_the_fused_kernel_rejects():
    with pytest.raises(ValueError):
        CudaLFCC(LFCCConfig(win_length=400, hop_length=160), device="cpu")
    with pytest.raises(ValueError):
        CudaLFCC(LFCCConfig(with_energy=True), device="cpu")


def test_energy_variant_of_plain_lfcc():
    wav = _wav((2, 4000), seed=9)
    cfg = dict(with_energy=True)
    want = np.asarray(JLFCC(JConfig(**cfg))(jnp.asarray(wav)))
    got = LFCC(LFCCConfig(**cfg), device="cpu")(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_silence_frame_matches():
    want = JLFCC().silence_frame()
    got = LFCC(device="cpu").silence_frame().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
