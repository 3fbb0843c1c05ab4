"""Batching: feature pad/crop policies, collation, the sequential scoring
iterator, and fixed-shape waveform batches for the on-device front-end.

The port's own copy of the JAX package's ``data/pipeline.py``:

- ``pad_or_crop`` / ``collate``: a feature (1, T, D) longer than
  ``feat_len`` is cropped (at a random start when given a generator, else
  at 0); a shorter one is zero-, repeat- or silence-padded, silence
  *prepended* as the reference does;
- ``SequentialIterator``: deterministic batches for scoring, the last one
  filled up with repeats of its last item and a ``valid`` mask;
- ``WaveformIterator`` (with its index stream): long utterances are
  random-cropped to ``max_samples`` with draws from
  ``np.random.default_rng(seed)``, in the same order as the JAX package, so
  both crop a corpus the same way; short ones are zero-padded with their
  true length carried alongside.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_SILENCE_FRAME: Optional[np.ndarray] = None


def _silence_frame(dim: int) -> np.ndarray:
    """LFCC feature vector (dim,) of pure silence from the port's plain
    LFCC on the CPU with ``dim // 3`` filters, computed once per dim."""
    global _SILENCE_FRAME
    if _SILENCE_FRAME is None or _SILENCE_FRAME.shape[-1] != dim:
        from asvspoof2021_air_tpu_torch.ops.lfcc import LFCC, LFCCConfig

        lfcc = LFCC(LFCCConfig(n_filters=max(dim // 3, 1)), device="cpu")
        _SILENCE_FRAME = lfcc.silence_frame().numpy()
    return _SILENCE_FRAME


def pad_or_crop(feat: np.ndarray, feat_len: int, padding: str = "repeat",
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(1, T, D) -> (1, feat_len, D) by crop or by the padding policy."""
    _, t, d = feat.shape
    if t > feat_len:
        start = 0
        if rng is not None and t - feat_len > 0:
            start = int(rng.integers(0, t - feat_len))
        return feat[:, start:start + feat_len, :]
    if t < feat_len:
        pad = feat_len - t
        if padding == "zero":
            return np.concatenate(
                [feat, np.zeros((1, pad, d), feat.dtype)], axis=1)
        if padding == "repeat":
            reps = -(-feat_len // t)
            return np.tile(feat, (1, reps, 1))[:, :feat_len, :]
        if padding == "silence":
            sil = np.broadcast_to(_silence_frame(d), (1, pad, d)).astype(
                feat.dtype)
            return np.concatenate([sil, feat], axis=1)
        raise ValueError("padding should be zero, repeat, or silence")
    return feat


def collate(samples: Sequence[tuple], feat_len: int, padding: str,
            rng: Optional[np.random.Generator] = None,
            pad_chop: bool = True) -> Dict[str, np.ndarray]:
    """Dataset items -> a batch dict with "feat" (B, T, F) f32, "fname",
    and "tag"/"label" for labeled items, "channel" for augmented ones.
    ``pad_chop=False`` is the reference's variable-length collate:
    repeat-pad every item to the batch's longest + 1 frames."""
    if not pad_chop:
        feat_len = max(s[0].shape[1] for s in samples) + 1
        padding = "repeat"
    feats = np.concatenate(
        [pad_or_crop(s[0], feat_len, padding, rng) for s in samples], axis=0)
    batch: Dict[str, np.ndarray] = {"feat": feats.astype(np.float32),
                                    "fname": np.array([s[1] for s in samples])}
    if len(samples[0]) >= 4:
        batch["tag"] = np.array([s[2] for s in samples], np.int32)
        batch["label"] = np.array([s[3] for s in samples], np.int32)
    if len(samples[0]) >= 5:
        batch["channel"] = np.array([s[4] for s in samples], np.int32)
    return batch


class SequentialIterator:
    """Deterministic batches for scoring: the last, partial batch is filled
    up to ``batch_size`` with repeats of its last item, and ``valid`` marks
    the real rows, so every batch has one shape."""

    def __init__(self, dataset, batch_size: int, feat_len: int = 750,
                 padding: str = "repeat"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.feat_len = feat_len
        self.padding = padding

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            idx = list(range(start, min(start + self.batch_size, n)))
            valid = len(idx)
            idx += [idx[-1]] * (self.batch_size - valid)
            batch = collate([self.dataset[i] for i in idx], self.feat_len,
                            self.padding)
            batch["valid"] = np.arange(self.batch_size) < valid
            yield batch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)


class _IndexStream:
    """Endless, optionally reshuffled index stream over a range."""

    def __init__(self, indices: Sequence[int], rng: np.random.Generator,
                 shuffle: bool = True):
        self.indices = np.asarray(indices)
        self.rng = rng
        self.shuffle = shuffle
        self._pos = 0
        self._order = self._new_order()

    def _new_order(self):
        order = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def take(self, n: int) -> np.ndarray:
        out = []
        while n > 0:
            avail = len(self._order) - self._pos
            if avail == 0:
                self._order = self._new_order()
                self._pos = 0
                avail = len(self._order)
            k = min(n, avail)
            out.append(self._order[self._pos:self._pos + k])
            self._pos += k
            n -= k
        return np.concatenate(out)


class WaveformIterator:
    """Batches of {"wave" (B, max_samples) f32, "length", "fname", "tag",
    "label"}; an original:augmented ratio below 1 mixes the two parts of a
    dataset whose first ``num_original`` items are the originals."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        max_samples: int,
        ratio: float = 1.0,
        num_original: Optional[int] = None,
        seed: int = 688,
        steps_per_epoch: Optional[int] = None,
        shuffle: bool = True,
    ):
        if not (0 < ratio <= 1):
            raise ValueError("ratio must be in (0, 1]")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_samples = max_samples
        n = len(dataset)
        if num_original is None:
            num_original = getattr(dataset, "num_original", n)
        self.num_original = min(num_original, n)
        self.ori_bs = int(batch_size * ratio)
        self.aug_bs = batch_size - self.ori_bs
        if self.num_original == n:
            self.aug_bs = 0
            self.ori_bs = batch_size
        self.rng = np.random.default_rng(seed)
        self._ori = _IndexStream(np.arange(self.num_original), self.rng,
                                 shuffle)
        self._aug = (
            _IndexStream(np.arange(self.num_original, n), self.rng, shuffle)
            if self.aug_bs
            else None
        )
        self.steps_per_epoch = steps_per_epoch or -(
            -self.num_original // max(self.ori_bs, 1)
        )

    def _collate(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        waves = np.zeros((len(idx), self.max_samples), np.float32)
        lengths = np.zeros(len(idx), np.int32)
        fnames, tags, labels, channels = [], [], [], []
        for r, i in enumerate(idx):
            item = self.dataset[int(i)]
            w = np.asarray(item[0], np.float32).ravel()
            if len(w) > self.max_samples:
                start = int(self.rng.integers(0, len(w) - self.max_samples + 1))
                w = w[start:start + self.max_samples]
            waves[r, :len(w)] = w
            lengths[r] = len(w)
            fnames.append(item[1])
            tags.append(item[2] if len(item) > 2 else 0)
            labels.append(item[3] if len(item) > 3 else 0)
            if len(item) > 4:
                channels.append(item[4])
        batch = {
            "wave": waves,
            "length": lengths,
            "fname": np.array(fnames),
            "tag": np.array(tags, np.int32),
            "label": np.array(labels, np.int32),
        }
        if channels:
            batch["channel"] = np.array(channels)
        return batch

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(self.steps_per_epoch):
            idx = self._ori.take(self.ori_bs)
            if self._aug is not None:
                idx = np.concatenate([idx, self._aug.take(self.aug_bs)])
            yield self._collate(idx)
