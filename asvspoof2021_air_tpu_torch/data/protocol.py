"""ASVspoof protocol parsing and the label vocabularies the scorer needs.

The port's own copy of the JAX package's ``data/protocol.py`` (protocol
entries, their parser and path, attack tags and labels); the channel and
device vocabularies come with the augmented datasets of a later slice.
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

LABELS: Dict[str, int] = {"spoof": 1, "bonafide": 0}


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
