"""NCBI genetic-code tables and translation.

Replaces the reference's reliance on Biopython CodonTable + the wise2 codon
table file (annotation_tookit.py:230-234, arguments.py saa_regulator
gene-code map). Tables are built from the standard code plus NCBI's
documented per-table differences; the set covers every code selectable in
the reference (arguments.py:413-495) — mitochondrial codes 2,3,4,5,9,13,
14,16,21,22,23,24,25 and the standard code 1.

Amino acids are encoded as ints in BLOSUM62 order
(A R N D C Q E G H I L K M F P S T W Y V X *) so substitution-matrix
lookups in the alignment kernels are direct indexing.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

AA_ORDER = "ARNDCQEGHILKMFPSTWYVX*"
AA_INDEX: Dict[str, int] = {ch: i for i, ch in enumerate(AA_ORDER)}
X_CODE = AA_INDEX["X"]
STOP_CODE = AA_INDEX["*"]
NUM_AA = len(AA_ORDER)

# standard code, codons ordered with base order T, C, A, G (NCBI convention)
_STANDARD = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_TCAG = "TCAG"

# per-table codon reassignments (NCBI Genetic Codes document)
_DIFFS: Dict[int, Dict[str, str]] = {
    1: {},
    2: {"AGA": "*", "AGG": "*", "ATA": "M", "TGA": "W"},      # Vertebrate Mito
    3: {"ATA": "M", "CTT": "T", "CTC": "T", "CTA": "T", "CTG": "T", "TGA": "W"},
    4: {"TGA": "W"},                                            # Mold/Protozoan Mito
    5: {"AGA": "S", "AGG": "S", "ATA": "M", "TGA": "W"},      # Invertebrate Mito
    9: {"AAA": "N", "AGA": "S", "AGG": "S", "TGA": "W"},      # Echinoderm/Flatworm
    13: {"AGA": "G", "AGG": "G", "ATA": "M", "TGA": "W"},     # Ascidian Mito
    14: {"AAA": "N", "AGA": "S", "AGG": "S", "TAA": "Y", "TGA": "W"},
    16: {"TAG": "L"},                                           # Chlorophycean Mito
    21: {"TGA": "W", "ATA": "M", "AGA": "S", "AGG": "S", "AAA": "N"},
    22: {"TCA": "*", "TAG": "L"},                               # Scenedesmus Mito
    23: {"TTA": "*"},                                           # Thraustochytrium Mito
    24: {"AGA": "S", "AGG": "K", "TGA": "W"},                  # Rhabdopleuridae Mito
    25: {"TGA": "G"},                                           # SR1/Gracilibacteria
}

_STARTS: Dict[int, Tuple[str, ...]] = {
    1: ("TTG", "CTG", "ATG"),
    2: ("ATT", "ATC", "ATA", "ATG", "GTG"),
    3: ("ATA", "ATG", "GTG"),
    4: ("TTA", "TTG", "CTG", "ATT", "ATC", "ATA", "ATG", "GTG"),
    5: ("TTG", "ATT", "ATC", "ATA", "ATG", "GTG"),
    9: ("ATG", "GTG"),
    13: ("TTG", "ATA", "ATG", "GTG"),
    14: ("ATG",),
    16: ("ATG",),
    21: ("ATG", "GTG"),
    22: ("ATG",),
    23: ("ATT", "ATG", "GTG"),
    24: ("TTG", "CTG", "ATG", "GTG"),
    25: ("ATG", "GTG"),
}

# base codes from io.encoding: A=0 C=1 G=2 T=3
_BASE_OF = {"A": 0, "C": 1, "G": 2, "T": 3}


class GeneticCode:
    """One NCBI translation table as dense arrays over base codes."""

    def __init__(self, table_id: int):
        if table_id not in _DIFFS:
            raise KeyError(f"genetic code table {table_id} not supported")
        self.id = table_id
        fwd: Dict[str, str] = {}
        i = 0
        for b1 in _TCAG:
            for b2 in _TCAG:
                for b3 in _TCAG:
                    fwd[b1 + b2 + b3] = _STANDARD[i]
                    i += 1
        fwd.update(_DIFFS[table_id])
        self.forward: Dict[str, str] = fwd
        self.stops: Set[str] = {c for c, a in fwd.items() if a == "*"}
        self.starts: Set[str] = set(_STARTS[table_id])
        # dense lookup: codon index = b0*16 + b1*4 + b2 (base codes)
        self.aa_lut = np.full(64, X_CODE, dtype=np.int8)
        self.is_start_lut = np.zeros(64, dtype=bool)
        for codon, aa in fwd.items():
            idx = _BASE_OF[codon[0]] * 16 + _BASE_OF[codon[1]] * 4 + _BASE_OF[codon[2]]
            self.aa_lut[idx] = AA_INDEX[aa]
        for codon in self.starts:
            idx = _BASE_OF[codon[0]] * 16 + _BASE_OF[codon[1]] * 4 + _BASE_OF[codon[2]]
            self.is_start_lut[idx] = True

    def translate_codes(self, codes: np.ndarray, frame: int = 0) -> np.ndarray:
        """Base codes [L] → aa codes [ (L-frame)//3 ]; codons containing
        N/pad translate to X."""
        codes = np.asarray(codes)[frame:]
        n = len(codes) // 3
        if n == 0:
            return np.zeros(0, np.int8)
        tri = codes[: n * 3].reshape(n, 3).astype(np.int32)
        bad = (tri >= 4).any(axis=1)
        idx = tri[:, 0] * 16 + tri[:, 1] * 4 + tri[:, 2]
        out = self.aa_lut[np.where(bad, 0, idx)]
        out[bad] = X_CODE
        return out

    def translate_str(self, seq: str, frame: int = 0) -> str:
        from ..io import encoding

        return aa_decode(self.translate_codes(encoding.encode(seq), frame))


_CACHE: Dict[int, GeneticCode] = {}


def get_code(table_id: int) -> GeneticCode:
    if table_id not in _CACHE:
        _CACHE[table_id] = GeneticCode(table_id)
    return _CACHE[table_id]


def aa_encode(pep: str) -> np.ndarray:
    return np.array([AA_INDEX.get(c.upper(), X_CODE) for c in pep], dtype=np.int8)


def aa_decode(codes: np.ndarray) -> str:
    return "".join(AA_ORDER[int(c)] for c in np.asarray(codes))


def six_frame_translate(codes: np.ndarray, table_id: int) -> List[Tuple[int, np.ndarray]]:
    """All 6 reading frames of a base-code sequence.

    Returns [(frame, aa_codes)] with frame in (1,2,3,-1,-2,-3) using BLAST
    frame numbering: positive = offset on the forward strand, negative =
    offset on the reverse complement."""
    from ..io import encoding

    gc = get_code(table_id)
    rc = np.asarray(encoding.revcomp(codes))
    out = []
    for f in range(3):
        out.append((f + 1, gc.translate_codes(codes, f)))
    for f in range(3):
        out.append((-(f + 1), gc.translate_codes(rc, f)))
    return out


# --------------------------------------------------------------- BLOSUM62
# canonical NCBI BLOSUM62, rows/cols in AA_ORDER[:20] + X + *
_B62_20 = [
    # A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [ 4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0],
    [-1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3],
    [-2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3],
    [-2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3],
    [ 0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],
    [-1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2],
    [-1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2],
    [ 0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3],
    [-2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3],
    [-1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3],
    [-1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1],
    [-1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2],
    [-1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1],
    [-2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1],
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2],
    [ 1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2],
    [ 0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0],
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3],
    [-2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2,  2,  2,  7, -1],
    [ 0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -1,  4],
]


def blosum62() -> np.ndarray:
    """[22, 22] int32: 20 aa + X (-1 vs all) + * (-4 vs all, +1 vs *)."""
    m = np.full((NUM_AA, NUM_AA), -1, dtype=np.int32)
    m[:20, :20] = np.array(_B62_20, dtype=np.int32)
    m[STOP_CODE, :] = -4
    m[:, STOP_CODE] = -4
    m[STOP_CODE, STOP_CODE] = 1
    m[X_CODE, :20] = -1
    m[:20, X_CODE] = -1
    m[X_CODE, X_CODE] = -1
    m[X_CODE, STOP_CODE] = -4
    m[STOP_CODE, X_CODE] = -4
    return m
