"""Synthetic data generators shared across tests: random genomes, shotgun
reads with quality strings, FASTQ/FASTA writers. Replaces the reference's
external golden-sample tarball (README.md:102-118) with deterministic
in-repo fixtures."""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng: np.random.Generator, length: int, circular: bool = False) -> str:
    seq = BASES[rng.integers(0, 4, size=length)].tobytes().decode()
    return seq


def shotgun_reads(
    rng: np.random.Generator,
    genome: str,
    n_reads: int,
    read_len: int = 100,
    circular: bool = False,
    error_rate: float = 0.0,
    insert: int = 0,
):
    """Uniform single-end reads (or PE pairs if insert>0) from both strands.

    Returns list of (seq, qual) or list of ((seq1,q1),(seq2,q2)).
    """
    comp = str.maketrans("ACGT", "TGCA")
    g2 = genome + (genome[: read_len + insert] if circular else "")
    span = insert if insert else read_len
    max_start = len(g2) - span
    out = []
    for _ in range(n_reads):
        start = int(rng.integers(0, max(max_start, 1)))
        frag = g2[start : start + span]
        if error_rate:
            chars = list(frag)
            for i in range(len(chars)):
                if rng.random() < error_rate:
                    chars[i] = "ACGT"[int(rng.integers(0, 4))]
            frag = "".join(chars)
        if insert:
            r1 = frag[:read_len]
            r2 = frag[-read_len:].translate(comp)[::-1]
            if rng.random() < 0.5:
                r1, r2 = r2, r1
            out.append(((r1, "I" * len(r1)), (r2, "I" * len(r2))))
        else:
            if rng.random() < 0.5:
                frag = frag.translate(comp)[::-1]
            out.append((frag, "I" * len(frag)))
    return out


def write_fastq(path, reads):
    with open(path, "w") as f:
        for i, (seq, qual) in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    return str(path)


def write_fasta(path, seqs):
    with open(path, "w") as f:
        for name, seq in seqs:
            f.write(f">{name}\n{seq}\n")
    return str(path)
