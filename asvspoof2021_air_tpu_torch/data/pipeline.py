"""Fixed-shape waveform batching for the on-device front-end.

The port's own copy of the JAX package's ``data/pipeline.py``
``WaveformIterator`` (with its index stream). Long utterances are
random-cropped to ``max_samples`` with draws from
``np.random.default_rng(seed)``, in the same order as the JAX package, so
both crop a corpus the same way; short ones are zero-padded with their true
length carried alongside.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np


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
