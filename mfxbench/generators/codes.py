"""NCBI translation tables the generators need, written out here so that
the yardstick does not read the program's own table."""

from __future__ import annotations

from typing import Dict

_BASES = "TCAG"
_STANDARD = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
# table id -> codon -> amino acid, where it differs from the standard code
_DIFFS: Dict[int, Dict[str, str]] = {
    1: {},
    2: {"AGA": "*", "AGG": "*", "ATA": "M", "TGA": "W"},   # vertebrate mitochondrial
    5: {"AGA": "S", "AGG": "S", "ATA": "M", "TGA": "W"},   # invertebrate mitochondrial
}


def table(table_id: int) -> Dict[str, str]:
    """codon (DNA) -> one-letter amino acid, ``*`` for a stop."""
    out = {}
    i = 0
    for a in _BASES:
        for b in _BASES:
            for c in _BASES:
                out[a + b + c] = _STANDARD[i]
                i += 1
    out.update(_DIFFS[table_id])
    return out


def translate(nt: str, table_id: int) -> str:
    t = table(table_id)
    return "".join(t.get(nt[i:i + 3], "X") for i in range(0, len(nt) - 2, 3))
