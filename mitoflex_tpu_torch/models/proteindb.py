"""Mitochondrial protein database loader.

Parses the reference's per-clade protein FASTAs
(profile/MT_database/{clade}.fa) whose ID contract is

    gi_NC_{accession}_{gene}_{genus}_{species}_{len}_aa

(reference README.md:289; e.g. ``gi_NC_006379_ATP6_Urechis_caupo_247_aa``).
The pipeline leans on this contract for gene naming and the species vote
(annotation/annotation.py:111-131), so it is parsed into structured
records. The "Animal" merged database (findmitoscaf.py:112-121 regenerates
it by concatenating all clade files) is reproduced by
:func:`load_merged`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io import fasta
from . import codon

PCG_NAMES = (
    "ATP6", "ATP8", "COX1", "COX2", "COX3", "CYTB",
    "ND1", "ND2", "ND3", "ND4", "ND4L", "ND5", "ND6",
)

_ID_RE = re.compile(
    r"^gi_(?P<acc>[A-Z]{2}_?\d+)_(?P<gene>[A-Za-z0-9]+)_(?P<genus>[^_]+)_(?P<species>.+?)_(?P<len>\d+)_aa$"
)


@dataclass
class ProteinRecord:
    id: str
    gene: str
    taxon: str            # "Genus species"
    accession: str
    seq: str              # amino acids
    aa_codes: np.ndarray  # encoded in BLOSUM order

    @property
    def length(self) -> int:
        return len(self.seq)


def parse_protein_id(pid: str) -> Dict[str, str]:
    m = _ID_RE.match(pid)
    if not m:
        # fall back: underscore-separated, gene in 4th field when possible
        parts = pid.split("_")
        gene = next((p for p in parts if p.upper() in PCG_NAMES), "?")
        return {"acc": pid, "gene": gene, "taxon": pid}
    d = m.groupdict()
    return {
        "acc": d["acc"],
        "gene": d["gene"].upper(),
        "taxon": f"{d['genus']} {d['species'].replace('_', ' ')}",
    }


def load_protein_db(path: str) -> List[ProteinRecord]:
    out = []
    for rec in fasta.read_fasta(path):
        meta = parse_protein_id(rec.id)
        out.append(
            ProteinRecord(
                id=rec.id,
                gene=meta["gene"],
                taxon=meta["taxon"],
                accession=meta["acc"],
                seq=rec.seq,
                aa_codes=codon.aa_encode(rec.seq),
            )
        )
    return out


def load_merged(profile_dir: str, clades: Optional[Sequence[str]] = None) -> List[ProteinRecord]:
    """The 'Animal.fa' union DB (reference findmitoscaf.py:112-121)."""
    dbdir = os.path.join(profile_dir, "MT_database")
    out: List[ProteinRecord] = []
    for name in sorted(os.listdir(dbdir)):
        if not name.endswith(".fa"):
            continue
        clade = os.path.splitext(name)[0]
        if clades and clade not in clades:
            continue
        if clade == "Animal":
            continue
        out.extend(load_protein_db(os.path.join(dbdir, name)))
    return out


class ProteinBatch:
    """Padded [n, max_len] aa-code matrix for device alignment."""

    def __init__(self, records: Sequence[ProteinRecord], pad_to: int = 8):
        self.records = list(records)
        n = len(self.records)
        mx = max((r.length for r in self.records), default=pad_to)
        mx = -(-mx // pad_to) * pad_to
        self.codes = np.full((max(n, 1), mx), codon.X_CODE, dtype=np.int8)
        self.lengths = np.zeros(max(n, 1), dtype=np.int32)
        for i, r in enumerate(self.records):
            self.codes[i, : r.length] = r.aa_codes
            self.lengths[i] = r.length
