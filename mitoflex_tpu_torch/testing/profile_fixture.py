"""Synthetic profile-set fixture: builds a fake clade ("Testa") with a few
PCGs, an on-disk profile directory (CDS_HMM/MT_database/codes.json/
required_cds.json) compatible with models/profiles.ProfileSet, and a
matching synthetic circular mitogenome. The same seed gives the same
genome and profile set as the test suite's fixture of the same name (which
can also link RNA covariance models; the port has no annotate stage yet, so
this copy makes the PCG part only)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..models import codon
from ..models import hmm as hmm_models
from . import synth

GENES = ["COX1", "ND1", "ATP6", "CYTB"]
GENE_LENS = {"COX1": 300, "ND1": 240, "ATP6": 210, "CYTB": 270}


@dataclass
class FakeMito:
    profile_dir: str
    clade: str
    genome: str               # circular mitogenome sequence
    gene_pos: Dict[str, Tuple[int, int, int]]  # gene -> (start, end, strand)
    gene_nt: Dict[str, str]
    table_id: int = 5


def build(tmp_path, rng, clade="Testa", spacer=120) -> FakeMito:
    pdir = str(tmp_path / "profile")
    os.makedirs(os.path.join(pdir, "CDS_HMM"), exist_ok=True)
    os.makedirs(os.path.join(pdir, "MT_database"), exist_ok=True)
    gc = codon.get_code(5)

    gene_nt: Dict[str, str] = {}
    for g in GENES:
        # random ORF without stops: build from random non-stop codons
        codons = [c for c, a in gc.forward.items() if a not in "*"]
        n = GENE_LENS[g] // 3
        gene_nt[g] = "ATG" + "".join(
            codons[int(i)] for i in rng.integers(0, len(codons), n - 1)
        )

    genome_parts = []
    gene_pos: Dict[str, Tuple[int, int, int]] = {}
    pos = 0
    for gi, g in enumerate(GENES):
        sp = synth.random_genome(rng, spacer)
        genome_parts.append(sp)
        pos += len(sp)
        nt = gene_nt[g]
        strand = 1 if gi % 2 == 0 else -1
        placed = nt if strand == 1 else _rc(nt)
        genome_parts.append(placed)
        gene_pos[g] = (pos, pos + len(nt), strand)
        pos += len(nt)
    genome_parts.append(synth.random_genome(rng, spacer))
    genome = "".join(genome_parts)

    # HMM profiles from the exact gene sequences
    hmms = [hmm_models.profile_from_consensus(g, gene_nt[g]) for g in GENES]
    hmm_models.write_hmm_file(hmms, os.path.join(pdir, "CDS_HMM", f"{clade}.hmm"))
    with open(os.path.join(pdir, "CDS_HMM", "required_cds.json"), "w") as f:
        json.dump({clade: {g: len(gene_nt[g]) for g in GENES}}, f)
    with open(os.path.join(pdir, "codes.json"), "w") as f:
        json.dump({clade: 5}, f)

    # protein DB: translations attributed to two taxa (one in-clade, one out)
    with open(os.path.join(pdir, "MT_database", f"{clade}.fa"), "w") as f:
        for g in GENES:
            pep = gc.translate_str(gene_nt[g]).rstrip("*")
            f.write(f">gi_NC_000101_{g}_Drosophila_melanogaster_{len(pep)}_aa\n{pep}\n")
            f.write(f">gi_NC_000201_{g}_Homo_sapiens_{len(pep)}_aa\n{pep}\n")

    return FakeMito(pdir, clade, genome, gene_pos, gene_nt)


def _rc(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
