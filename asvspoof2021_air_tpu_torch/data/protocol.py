"""ASVspoof protocol parsing and label vocabularies.

The port's own copy of the JAX package's ``data/protocol.py``: protocol
entries, their parser and path, and the vocabularies that keep tag, label,
channel and device ids compatible with the reference's checkpoints and
score files:
- attack tags (ASVspoof2019 LA/PA, ASVspoof2015, the augmented-training
  subset);
- labels spoof=1 / bonafide=0;
- the LA codec channel vocabulary (60 entries), the DF compression
  vocabulary (7), the device impulse-response vocabulary (13) and the
  full device and space IR inventories (74 and 15 stems).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

LA_TAGS: Dict[str, int] = {
    "-": 0, "A01": 1, "A02": 2, "A03": 3, "A04": 4, "A05": 5, "A06": 6,
    "A07": 7, "A08": 8, "A09": 9, "A10": 10, "A11": 11, "A12": 12, "A13": 13,
    "A14": 14, "A15": 15, "A16": 16, "A17": 17, "A18": 18, "A19": 19,
}

PA_TAGS: Dict[str, int] = {
    "-": 0, "AA": 1, "AB": 2, "AC": 3, "BA": 4, "BB": 5, "BC": 6,
    "CA": 7, "CB": 8, "CC": 9,
}

ASVSPOOF2015_TAGS: Dict[str, int] = {
    "human": 0, "S1": 1, "S2": 2, "S3": 3, "S4": 4, "S5": 5,
    "S6": 6, "S7": 7, "S8": 8, "S9": 9, "S10": 10,
}

# Augmented-training tag vocabulary: train/dev attacks only
# (the reference implementation's dataset.py:120).
LA_TRAIN_TAGS: Dict[str, int] = {
    "-": 0, "A01": 1, "A02": 2, "A03": 3, "A04": 4, "A05": 5, "A06": 6,
}

LABELS: Dict[str, int] = {"spoof": 1, "bonafide": 0}

LA_CHANNELS: List[str] = [
    "no_channel", "amr[br=10k2,nodtx]", "amr[br=5k9]", "amr[br=6k7,nodtx]",
    "amr[br=7k95,nodtx]", "amrwb[br=12k65]", "amrwb[br=15k85]", "g711[law=a]",
    "g711[law=u]", "g722[br=64k]", "g726[law=a,br=16k]", "g726[law=a,br=24k]",
    "g726[law=u,40k]", "g726[law=u,br=24k]", "g726[law=u,br=32k]", "g728",
    "silk[br=10k,loss=10]", "silk[br=15k,loss=5]", "silk[br=15k]",
    "silk[br=20k,loss=5]", "silk[br=5k,loss=10]", "silk[br=5k]", "amr[br=12k2]",
    "amr[br=5k9,nodtx]", "amrwb[br=6k6,nodtx]", "g722[br=56k]",
    "g726[law=a,br=32k]", "g726[law=a,br=40k]", "silk[br=15k,loss=10]",
    "silk[br=20k]", "silkwb[br=10k,loss=5]", "amr[br=10k2]", "amr[br=4k75]",
    "amr[br=7k95]", "amrwb[br=15k85,nodtx]", "amrwb[br=23k05]",
    "g726[law=u,br=16k]", "g729a", "gsmfr", "silkwb[br=10k,loss=10]",
    "silkwb[br=20k]", "silkwb[br=30k,loss=10]", "amr[br=7k4,nodtx]",
    "amrwb[br=6k6]", "silk[br=10k]", "silk[br=5k,loss=5]",
    "silkwb[br=30k,loss=5]", "amr[br=4k75,nodtx]", "amr[br=7k4]",
    "g722[br=48k]", "silk[br=20k,loss=10]", "silkwb[br=30k]", "amr[br=5k15]",
    "silkwb[br=20k,loss=5]", "amrwb[br=23k05,nodtx]", "amrwb[br=12k65,nodtx]",
    "silkwb[br=20k,loss=10]", "amr[br=6k7]", "silkwb[br=10k]",
    "silk[br=10k,loss=5]",
]

DF_CHANNELS: List[str] = [
    "no_channel", "aac[16k]", "aac[32k]", "aac[8k]",
    "mp3[16k]", "mp3[32k]", "mp3[8k]",
]

DEVICES: List[str] = [
    "OktavaML19-16000.ir", "iPhoneirRecording-16000.ir",
    "iPadirRecording-16000.ir", "ResloRB250-16000.ir",
    "telephonehornT65C-16000.ir", "ResloSR1-16000.ir", "RCAPB90-16000.ir",
    "ResloRBRedLabel-16000.ir", "telephone90sC-16000.ir",
    "SonyC37Fet-16000.ir", "Doremi-16000.ir", "BehritoneirRecording-16000.ir",
    "",
]

LA_CHANNEL_INDEX = {c: i for i, c in enumerate(LA_CHANNELS)}
DF_CHANNEL_INDEX = {c: i for i, c in enumerate(DF_CHANNELS)}
DEVICE_INDEX = {d: i for i, d in enumerate(DEVICES)}


@dataclasses.dataclass(frozen=True)
class ProtocolEntry:
    speaker: str
    filename: str
    system: str
    tag: str
    label: str


def parse_protocol(path: str) -> List[ProtocolEntry]:
    """Parse an ASVspoof2019 CM protocol file: one
    ``speaker filename system tag label`` line per trial."""
    entries = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) != 5:
                raise ValueError(f"malformed protocol line in {path}: {line!r}")
            entries.append(ProtocolEntry(*parts))
    return entries


def protocol_path(
    database_root: str, access_type: str, part: str,
    protocol_root: Optional[str] = None,
) -> str:
    """Standard location of the ASVspoof2019 CM protocol."""
    root = protocol_root or os.path.join(
        database_root, access_type, f"ASVspoof2019_{access_type}_cm_protocols"
    )
    return os.path.join(root, f"ASVspoof2019.{access_type}.cm.{part}.trl.txt")


# Full IR inventories of the reference device/space augmentation
# (the reference's ir-device-file-list.txt: 74 device IRs,
# ir-space-file-list.txt: 15 space IRs) — filename stems only (the recorded
# IRs are not shipped by the reference either; ``cli.degrade make-irs``
# synthesizes a stand-in bank under these names).
DEVICE_IR_INVENTORY: List[str] = [
    "Carradiowide-16000", "BlaupunkttuberadioC-16000",
    "ErrestuberadioC-16000", "ironboxmono-16000", "Errestuberadiov21-16000",
    "Errestuberadiov22-16000", "Ironspeaker2-16000", "Ironspeaker1-16000",
    "Verysmallspeakermono-16000", "Smallportable-16000",
    "Smallspeaker2-16000", "Smallspeaker1-16000", "Carradioclose-16000",
    "70sPhilipsboxstereo-16000", "walkmanEQ-16000",
    "Blaupunkttuberadio-16000", "telephone90sC-16000",
    "telephonehornT65C-16000", "Smallspeakermono-16000",
    "Verysmallspeaker2-16000", "Verysmallspeaker1-16000",
    "Smallportableambient-16000", "walkman-16000", "70sPhilipsboxmono-16000",
    "BehritoneirRecording-16000", "iPhoneirRecording-16000",
    "iPadirRecording-16000", "OktavaML19-16000", "RCAPB90-16000",
    "Doremi-16000", "ResloSR1-16000", "ResloRBRedLabel-16000",
    "SonyC37Fet-16000", "ResloRB250-16000", "AKSPKRSRadio001-16000",
    "AKSPKRS009-16000", "AKSPKRS003-16000", "AKSPKRS016-16000",
    "AKSPKRS012-16000", "AKSPKRS008-16000", "AKSPKRS002-16000",
    "AKSPKRS010-16000", "AKSPKRS014-16000", "AKSPKRSSpeaker002-16000",
    "AKSPKRSSpeaker001-16000", "AKSPKRS004-16000", "AKSPKRS001-16000",
    "AKSPKRS80sUs002-16000", "AKSPKRS80sUs001-16000", "AKSPKRS017-16000",
    "AKSPKRS006-16000", "AKSPKRS013-16000", "AKSPKRS005-16000",
    "AKSPKRS018-16000", "AKSPKRSModUk001-16000", "AKSPKRSModUk002-16000",
    "AKSPKRSModUs001-16000", "AKSPKRSModUs004-16000",
    "AKSPKRSModUs003-16000", "AKSPKRSModUs002-16000", "AKSPKRS019-16000",
    "AKSPKRS015-16000", "AKSPKRS007-16000", "AKSPKRS80sUk002-16000",
    "AKSPKRS80sUk001-16000", "AKSPKRS011-16000", "AKSPKRSVinUk002-16000",
    "AKSPKRSVinUk001-16000", "AKSPKRSVinUs002-16000",
    "AKSPKRSVinUs001-16000", "DirectCabinetN3-16000",
    "DirectCabinetN2-16000", "DirectCabinetN1-16000",
    "DirectCabinetN4-16000"
]

SPACE_IR_INVENTORY: List[str] = [
    "smallroom3-16000", "smallplace6-16000", "clearroom1-16000",
    "AKSROOMS001-16000", "AKSROOMS016-16000", "AKSROOMS006-16000",
    "AKSROOMS007-16000", "SmallDrumRoom-16000", "BottleHall-16000",
    "CementBlocks2-16000", "CementBlocks1-16000", "TrigRoom-16000",
    "NiceDrumRoom-16000", "SmallPrehistoricCave-16000", "BlockInside-16000"
]
