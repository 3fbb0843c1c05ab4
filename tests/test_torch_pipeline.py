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


class _MixDataset(_Dataset):
    """Original items then augmented ones (feat, fname, tag, label,
    channel), lengths around feat_len = 40 so both the crop and the pad
    run."""

    def __init__(self, n_ori: int, n_aug: int):
        lens = [40, 23, 61, 55, 12, 40, 47, 33]
        super().__init__([
            (feats(lens[i % len(lens)] + i // len(lens), 30 + i),
             f"LA_T_{i:07d}", i % 3, i % 2, 0 if i < n_ori else 1 + i % 5)
            for i in range(n_ori + n_aug)])
        self.num_original = n_ori


@pytest.mark.parametrize("padding", ["repeat", "zero", "silence"])
@pytest.mark.parametrize("pad_chop", [True, False])
@pytest.mark.parametrize("ratio,n_aug", [(0.5, 7), (1.0, 0)])
def test_ratio_mix_iterator_equals_jax(ratio, n_aug, pad_chop, padding):
    """Two epochs (both index streams wrap around and reshuffle) of batch
    8 over 13 originals and, at ratio 0.5, an augmented tail of 7: the
    steps per epoch and every batch equal the JAX iterator's exactly, but
    the silence frame (atol 5e-4, the LFCC bar)."""
    ds = _MixDataset(13, n_aug)
    kw = dict(feat_len=40, padding=padding, seed=5, pad_chop=pad_chop)
    got_it = pp.RatioMixIterator(ds, 8, ratio, **kw)
    want_it = jp.RatioMixIterator(ds, 8, ratio, **kw)
    assert got_it.steps_per_epoch == want_it.steps_per_epoch == (
        4 if ratio == 0.5 else 2)
    for _ in range(2):
        got, want = list(got_it.epoch()), list(want_it.epoch())
        assert len(got) == len(want) == got_it.steps_per_epoch
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                if k == "feat" and padding == "silence":
                    np.testing.assert_allclose(g[k], w[k], atol=5e-4)
                else:
                    assert np.array_equal(g[k], w[k]), k
    if ratio == 0.5:
        assert (got[0]["channel"][:4] == 0).all()
        assert (got[0]["channel"][4:] > 0).all()
