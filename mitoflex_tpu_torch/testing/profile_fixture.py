"""Synthetic profile-set fixture: builds a fake clade ("Testa") with a few
PCGs, an on-disk profile directory (CDS_HMM/MT_database/codes.json/
required_cds.json) compatible with models/profiles.ProfileSet, and a
matching synthetic circular mitogenome. The same seed gives the same
genome and profile set as the test suite's fixture of the same name.

``link_rna=True`` also writes covariance models made by ``cm_fixture``
(``tRNA_CM/<clade>_<amino>.cm`` for a few amino letters, each with the
anticodon that the anticodon walk maps to its letter under genetic code 5,
and ``rRNA_CM/{12s,16s}.cm``) and plants their consensus sequences in the
genome's spacers, alternating strands. The PCGs and the spacers are drawn
first and in the same order either way, so the genes are the same; the
genome is longer by the planted RNAs."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..models import codon
from ..models import hmm as hmm_models
from . import cm_fixture, synth

GENES = ["COX1", "ND1", "ATP6", "CYTB"]
GENE_LENS = {"COX1": 300, "ND1": 240, "ATP6": 210, "CYTB": 270}
TRNA_AMINOS = ("F", "H", "K", "W")
RRNA_NAMES = {"12s": "rrnS", "16s": "rrnL"}


@dataclass
class FakeMito:
    profile_dir: str
    clade: str
    genome: str               # circular mitogenome sequence
    gene_pos: Dict[str, Tuple[int, int, int]]  # gene -> (start, end, strand)
    gene_nt: Dict[str, str]
    table_id: int = 5
    # with link_rna: locs.json name ("trnF", "rrnS", ...) -> (start, end,
    # strand), 0-based half-open on the genome like gene_pos
    rna_pos: Dict[str, Tuple[int, int, int]] = field(default_factory=dict)


def build(tmp_path, rng, clade="Testa", spacer=120, link_rna=False,
          rrna_clen: Sequence[int] = (950, 1100)) -> FakeMito:
    """``rrna_clen``: consensus lengths of the 12s and 16s fixture models
    (``link_rna`` only; the tests pass small ones)."""
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
    rna_pos: Dict[str, Tuple[int, int, int]] = {}
    if link_rna:
        genome_parts, gene_pos, rna_pos = _plant_rnas(
            pdir, rng, clade, genome_parts, gene_pos, gc, rrna_clen)
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

    return FakeMito(pdir, clade, genome, gene_pos, gene_nt, rna_pos=rna_pos)


def _plant_rnas(pdir, rng, clade, parts, gene_pos, gc, rrna_clen):
    """Write the fixture CMs and splice each consensus into the middle of a
    spacer (parts[0], parts[2], ...), odd ones reverse-complemented; returns
    the new parts and the shifted gene and RNA positions."""
    os.makedirs(os.path.join(pdir, "tRNA_CM"), exist_ok=True)
    os.makedirs(os.path.join(pdir, "rRNA_CM"), exist_ok=True)
    # the RNA models draw from their own stream, seeded from the caller's
    rna_rng = np.random.default_rng(int(rng.integers(0, 2**32)))
    planted: List[Tuple[str, str]] = []
    for amino in TRNA_AMINOS:
        codon_nt = next(c for c, a in sorted(gc.forward.items()) if a == amino)
        fx = cm_fixture.trna_cm(f"{clade}_{amino}", rna_rng, _rc(codon_nt))
        cm_fixture.write_cm(fx, os.path.join(pdir, "tRNA_CM", f"{clade}_{amino}.cm"))
        planted.append((f"trn{amino}", fx.consensus))
    for key, clen in zip(("12s", "16s"), rrna_clen):
        fx = cm_fixture.rrna_cm(key, rna_rng, int(clen))
        cm_fixture.write_cm(fx, os.path.join(pdir, "rRNA_CM", f"{key}.cm"))
        planted.append((RRNA_NAMES[key], fx.consensus))
    n_spacers = (len(parts) + 1) // 2
    inserts: Dict[int, List[Tuple[str, str, int]]] = {}
    for i, (name, seq) in enumerate(planted):
        strand = 1 if i % 2 == 0 else -1
        inserts.setdefault(2 * (i % n_spacers), []).append(
            (name, seq if strand == 1 else _rc(seq), strand))
    genes = sorted(gene_pos, key=lambda g: gene_pos[g][0])
    out, new_genes, rna_pos, pos = [], {}, {}, 0
    for pi, part in enumerate(parts):
        if pi % 2 == 1:
            g = genes[pi // 2]
            new_genes[g] = (pos, pos + len(part), gene_pos[g][2])
        pieces = [part]
        if pi in inserts:
            half = len(part) // 2
            pieces = [part[:half]]
            for name, seq, strand in inserts[pi]:
                pieces += [(name, seq, strand), synth.random_genome(rna_rng, 20)]
            pieces.append(part[half:])
        for piece in pieces:
            if isinstance(piece, tuple):
                name, piece, strand = piece
                rna_pos[name] = (pos, pos + len(piece), strand)
            out.append(piece)
            pos += len(piece)
    return out, new_genes, rna_pos


def _rc(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
