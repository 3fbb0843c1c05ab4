"""Feature-file and raw-audio datasets over the reference's on-disk layouts.

The port's own copy of the JAX package's ``data/datasets.py``. Cached
features follow the reference filename schema
``%06d_%s_%s_%s[_%s[_%s]].{npy|pt}`` = idx_filename_tag_label[_channel
[_device]]:

- ``ASVspoof2019FeatureDataset``: one part of the ASVspoof2019 cache,
  with the reference's ``genuine_only`` mode;
- ``AugmentedFeatureDataset``: original + augmented trees concatenated,
  the channel (and device) parsed from the filename suffix;
- ``EvalFeatureDataset``: the unlabeled challenge eval caches;
- ``RawAudioDataset`` and the other raw datasets: waveforms (WAV or FLAC)
  for the on-device front-end.

A ``.pt`` feature file is read with ``torch.load(..., weights_only=True)``:
a reference feature cache holds a plain tensor, so nothing else is
unpickled (the JAX package passes ``weights_only=False``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from asvspoof2021_air_tpu_torch.data import protocol as proto
from asvspoof2021_air_tpu_torch.data.audio_io import load_audio


def _find_feature_files(root: str) -> List[str]:
    """Sorted recursive scan for .npy/.pt feature files."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            if fn.endswith((".npy", ".pt")):
                out.append(os.path.join(dirpath, fn))
    out.sort()
    return out


def load_feature_file(path: str) -> np.ndarray:
    """A cached feature tensor (1, T, D) f32 from .npy or a torch .pt."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        arr = torch.load(path, map_location="cpu", weights_only=True)
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


def _basename_fields(path: str) -> List[str]:
    base = os.path.basename(path)
    for ext in (".npy", ".pt"):
        if base.endswith(ext):
            base = base[: -len(ext)]
            break
    return base.split("_")


class ASVspoof2019FeatureDataset:
    """Cached features of one part (train/dev/eval); items (feat (1, T, D)
    f32, filename, tag_id, label_id)."""

    def __init__(self, access_type: str, path_to_features: str,
                 part: str = "train", feature: str = "LFCC",
                 genuine_only: bool = False):
        if access_type == "LA":
            self.tag = proto.LA_TAGS
        elif access_type == "PA":
            self.tag = proto.PA_TAGS
        else:
            raise ValueError("access type should be LA or PA")
        self.label = proto.LABELS
        self.part = part
        self.files = _find_feature_files(
            os.path.join(path_to_features, part, feature))
        if genuine_only:
            if access_type != "LA":
                raise ValueError("genuine_only supported for LA only")
            if part in ("train", "dev"):
                # bona fide entries sort first in the reference cache layout
                num_bonafide = {"train": 2580, "dev": 2548}
                self.files = self.files[: num_bonafide[part]]
            else:
                self.files = [f for f in self.files if "bonafide" in f]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        fields = _basename_fields(path)
        if len(fields) != 6:
            raise ValueError(f"unexpected feature filename: {path}")
        filename = "_".join(fields[1:4])
        return (load_feature_file(path), filename, self.tag[fields[4]],
                self.label[fields[5]])


class AugmentedFeatureDataset:
    """Original + augmented feature trees with channel (and device) ids.

    ``variant`` 'LA' uses the 60-codec vocabulary, 'DF' the 7-compression
    one; with ``with_device`` the item carries np.array([channel_id,
    device_id]). Items below ``num_original`` are the original files, with
    channel 'no_channel'."""

    def __init__(self, path_to_ori: str, path_to_aug: str,
                 part: str = "train", feature: str = "LFCC",
                 variant: str = "LA", with_device: bool = False):
        self.tag = proto.LA_TRAIN_TAGS
        self.label = proto.LABELS
        self.channel = list(proto.LA_CHANNELS if variant == "LA"
                            else proto.DF_CHANNELS)
        self.channel_dict = {c: i for i, c in enumerate(self.channel)}
        self.with_device = with_device
        if with_device:
            self.devices = list(proto.DEVICES)
            self.device_dict = {d: i for i, d in enumerate(self.devices)}
        self.ori_files = _find_feature_files(
            os.path.join(path_to_ori, part, feature))
        self.aug_files = _find_feature_files(
            os.path.join(path_to_aug, part, feature))

    def __len__(self) -> int:
        return len(self.ori_files) + len(self.aug_files)

    @property
    def num_original(self) -> int:
        return len(self.ori_files)

    def __getitem__(self, idx: int):
        if idx < len(self.ori_files):
            path = self.ori_files[idx]
            fields = _basename_fields(path)
            if len(fields) != 6:
                raise ValueError(
                    f"unexpected original feature filename: {path}")
            channel, device = "no_channel", ""
        else:
            path = self.aug_files[idx - len(self.ori_files)]
            fields = _basename_fields(path)
            if len(fields) != (8 if self.with_device else 7):
                raise ValueError(
                    f"unexpected augmented feature filename: {path}")
            channel = fields[6]
            device = fields[7] if self.with_device else ""
        filename = "_".join(fields[1:4])
        if self.with_device:
            ch = np.array([self.channel_dict[channel],
                           self.device_dict[device]], np.int32)
        else:
            ch = self.channel_dict[channel]
        return (load_feature_file(path), filename, self.tag[fields[4]],
                self.label[fields[5]], ch)


class EvalFeatureDataset:
    """Unlabeled challenge eval features; items (feat, filename), from the
    schema idx_fname-parts."""

    def __init__(self, path_to_features: str, feature: str = "LFCC"):
        self.files = _find_feature_files(
            os.path.join(path_to_features, feature))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        fields = _basename_fields(path)
        if len(fields) != 4:
            raise ValueError(f"unexpected eval feature filename: {path}")
        return load_feature_file(path), "_".join(fields[1:])


class RawAudioDataset:
    """Items (waveform (L,), filename, tag, label) of one ASVspoof2019 part,
    read from ``<db>/<access>/ASVspoof2019_<access>_<part>/flac`` (or
    ``wav`` when there is no ``flac``)."""

    def __init__(
        self,
        access_type: str,
        path_to_database: str,
        part: str = "train",
        path_to_protocol: Optional[str] = None,
        sample_rate: int = 16000,
        audio_ext: str = ".flac",
    ):
        self.sample_rate = sample_rate
        self.audio_dir = os.path.join(
            path_to_database, access_type,
            f"ASVspoof2019_{access_type}_{part}", "flac",
        )
        if not os.path.isdir(self.audio_dir):
            alt = os.path.join(
                path_to_database, access_type,
                f"ASVspoof2019_{access_type}_{part}", "wav",
            )
            if os.path.isdir(alt):
                self.audio_dir = alt
                audio_ext = ".wav"
        self.audio_ext = audio_ext
        ppath = proto.protocol_path(path_to_database, access_type, part,
                                    path_to_protocol)
        self.entries = proto.parse_protocol(ppath)
        self.tag = proto.LA_TAGS if access_type == "LA" else proto.PA_TAGS
        self.label = proto.LABELS

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int):
        e = self.entries[idx]
        path = os.path.join(self.audio_dir, e.filename + self.audio_ext)
        wav, _sr = load_audio(path, self.sample_rate)
        return wav, e.filename, self.tag[e.tag], self.label[e.label]


class AugmentedRawAudioDataset:
    """Raw augmented wav trees ``<db>/<part>/**/<fname>_<channel>[_<device>]
    .wav`` with labels from the LA CM protocol; items (waveform, filename,
    tag, label, channel[, device]) with channel and device as strings."""

    def __init__(self, path_to_database: str, path_to_protocol: str,
                 part: str = "train", with_device: bool = False,
                 sample_rate: int = 16000):
        self.with_device = with_device
        self.sample_rate = sample_rate
        self.audio_dir = os.path.join(path_to_database, part)
        self.files = []
        for dirpath, _d, filenames in os.walk(self.audio_dir):
            self.files.extend(os.path.join(dirpath, fn) for fn in filenames
                              if fn.endswith(".wav"))
        self.files.sort()
        ppath = os.path.join(path_to_protocol,
                             f"ASVspoof2019.LA.cm.{part}.trl.txt")
        self.info = {e.filename: e for e in proto.parse_protocol(ppath)}
        # train/dev attacks, plus A07 as the reference has it
        self.tag = dict(proto.LA_TRAIN_TAGS, A07=7)
        self.label = proto.LABELS

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        parts = os.path.basename(path)[:-4].split("_")
        n_suffix = 2 if self.with_device else 1
        filename = "_".join(parts[:-n_suffix])
        wav, _sr = load_audio(path, self.sample_rate)
        entry = self.info[filename]
        tag, label = self.tag[entry.tag], self.label[entry.label]
        if self.with_device:
            return wav, filename, tag, label, parts[-2], parts[-1]
        return wav, filename, tag, label, parts[-1]


class ASVspoof2015RawDataset:
    """ASVspoof2015 raw audio from its protocol: per-speaker wav folders,
    tags human/S1..S10, labels human=0 / spoof=1."""

    def __init__(self, path_to_database: str, path_to_protocol: str,
                 part: str = "train", sample_rate: int = 16000):
        self.sample_rate = sample_rate
        self.path_to_audio = os.path.join(path_to_database, part)
        pro = {"train": "cm_train.trn", "dev": "cm_develop.ndx",
               "eval": "cm_evaluation.ndx"}[part]
        self.tag = proto.ASVSPOOF2015_TAGS
        self.label = {"spoof": 1, "human": 0}
        with open(os.path.join(path_to_protocol, pro)) as f:
            self.all_info = [line.strip().split() for line in f
                             if line.strip()]

    def __len__(self) -> int:
        return len(self.all_info)

    def __getitem__(self, idx: int):
        speaker, filename, tag, label = self.all_info[idx]
        path = os.path.join(self.path_to_audio, speaker, filename + ".wav")
        wav, _sr = load_audio(path, self.sample_rate)
        return (wav, filename.replace("_", "-"), self.tag[tag],
                self.label[label])


class VCC2020RawDataset:
    """VCC2020 raw audio: bona fide from the database tree, spoof from the
    listening-test tree (its tag is the conversion system's folder); items
    (waveform, filename, tag, label) with tag and label as strings."""

    def __init__(self, path_to_spoof: str, path_to_bonafide: str,
                 sample_rate: int = 16000):
        self.sample_rate = sample_rate

        def find_wavs(root):
            out = []
            for dirpath, _d, files in os.walk(root):
                out.extend(os.path.join(dirpath, f) for f in files
                           if f.endswith(".wav"))
            return sorted(out)

        self.all_spoof = find_wavs(path_to_spoof)
        self.all_bonafide = find_wavs(path_to_bonafide)

    def __len__(self) -> int:
        return len(self.all_spoof) + len(self.all_bonafide)

    def __getitem__(self, idx: int):
        if idx < len(self.all_bonafide):
            path = self.all_bonafide[idx]
            label, tag = "bonafide", "-"
            filename = "_".join(path.split(os.sep)[-3:])[:-4]
        else:
            path = self.all_spoof[idx - len(self.all_bonafide)]
            label = "spoof"
            tag = path.split(os.sep)[-3]
            filename = os.path.basename(path)[:-4]
        wav, _sr = load_audio(path, self.sample_rate)
        return wav, filename, tag, label


class ASVspoof2021EvalRawDataset:
    """Unlabeled ASVspoof2021 eval audio, WAV and FLAC, in a sorted walk of
    the tree; items (waveform, filename)."""

    def __init__(self, path_to_database: str, sample_rate: int = 16000):
        self.sample_rate = sample_rate
        self.files = []
        for dirpath, _d, files in os.walk(path_to_database):
            self.files.extend(os.path.join(dirpath, f) for f in files
                              if f.endswith((".wav", ".flac")))
        self.files.sort()

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        wav, _sr = load_audio(path, self.sample_rate)
        return wav, os.path.splitext(os.path.basename(path))[0]
