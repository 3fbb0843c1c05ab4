"""Protocol-driven raw-audio dataset for the on-device front-end.

The port's own copy of the JAX package's ``data/datasets.py``
``RawAudioDataset``; the feature-file datasets come with a later slice.
"""

from __future__ import annotations

import os
from typing import Optional

from asvspoof2021_air_tpu_torch.data import protocol as proto
from asvspoof2021_air_tpu_torch.data.audio_io import load_audio


class RawAudioDataset:
    """Items (waveform (L,), filename, tag, label) of one ASVspoof2019 part,
    read from ``<db>/<access>/ASVspoof2019_<access>_<part>/{flac,wav}``."""

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
