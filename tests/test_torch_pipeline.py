"""The port's feature batching against the JAX package's ``data/pipeline``:
pad/crop policies, collation and the sequential scoring iterator. Batches
are equal exactly (``np.array_equal``), but the silence padding, whose
frame comes from each package's own LFCC: atol 5e-4, the LFCC bar."""

import numpy as np
import pytest

from asvspoof2021_air_tpu.data import pipeline as jp
from asvspoof2021_air_tpu_torch.data import pipeline as pp

D = 60


def feats(t: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, t, D)).astype(
        np.float32)


@pytest.mark.parametrize("padding", ["zero", "repeat"])
@pytest.mark.parametrize("t", [7, 23, 50, 61])
def test_pad_or_crop_equals_jax(padding, t):
    x = feats(t, t)
    assert np.array_equal(pp.pad_or_crop(x, 50, padding),
                          jp.pad_or_crop(x, 50, padding))
    got = pp.pad_or_crop(x, 50, padding, np.random.default_rng(4))
    want = jp.pad_or_crop(x, 50, padding, np.random.default_rng(4))
    assert got.shape == (1, 50, D) and np.array_equal(got, want)


def test_silence_padding_prepends_the_jax_silence_frame():
    x = feats(13, 1)
    got, want = pp.pad_or_crop(x, 50, "silence"), jp.pad_or_crop(
        x, 50, "silence")
    assert got.shape == want.shape == (1, 50, D)
    assert np.array_equal(got[:, 37:], x)
    np.testing.assert_allclose(got, want, atol=5e-4)
    with pytest.raises(ValueError):
        pp.pad_or_crop(x, 50, "mirror")


def _items(kind: str):
    lens = [50, 12, 71, 33, 5]
    out = []
    for i, t in enumerate(lens):
        item = (feats(t, 10 + i), f"LA_D_{i:07d}")
        if kind != "eval":
            item += (i % 3, i % 2)
        if kind == "channel":
            item += (i + 1,)
        out.append(item)
    return out


@pytest.mark.parametrize("kind", ["eval", "labeled", "channel"])
@pytest.mark.parametrize("pad_chop", [True, False])
def test_collate_equals_jax(kind, pad_chop):
    items = _items(kind)
    got = pp.collate(items, 40, "repeat", np.random.default_rng(2), pad_chop)
    want = jp.collate(items, 40, "repeat", np.random.default_rng(2), pad_chop)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got["feat"].shape[1] == (40 if pad_chop else 72)


class _Dataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("kind", ["eval", "labeled"])
@pytest.mark.parametrize("padding", ["zero", "repeat"])
def test_sequential_iterator_equals_jax(kind, padding):
    """Batches of 3 over 5 items: the last one filled up with repeats of
    its last item, ``valid`` marking the real rows."""
    ds = _Dataset(_items(kind))
    got = list(pp.SequentialIterator(ds, 3, 40, padding))
    want = list(jp.SequentialIterator(ds, 3, 40, padding))
    assert len(got) == len(want) == len(pp.SequentialIterator(ds, 3)) == 2
    assert got[1]["valid"].tolist() == [True, True, False]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.array_equal(g[k], w[k]), k


def test_sequential_iterator_silence_padding_equals_jax():
    ds = _Dataset(_items("labeled"))
    got = list(pp.SequentialIterator(ds, 4, 40, "silence"))
    want = list(jp.SequentialIterator(ds, 4, 40, "silence"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["feat"], w["feat"], atol=5e-4)
        assert np.array_equal(g["valid"], w["valid"])
        assert np.array_equal(g["fname"], w["fname"])
