"""Paired-end WGS reads of a mitogenome and a nuclear stand-in, as gzip FASTQ.

The vectorised successor of the port's ``testing/synth.shotgun_reads``:
fragments of normal length (``insert_mean``, ``insert_sd``) start uniformly
on the circular mitogenome and on a random linear nuclear stand-in, each at
its coverage; a pair is the fragment's two ends, read 2 reverse-complemented,
and the mates swap places with probability one half. Substitutions hit
``substitution_rate`` of the bases (always another base). Qualities are
Phred+33: a base is of low quality (Phred 2-20) with probability
``low_base_share``, else Phred 25-40; in ``bad_pair_share`` of the pairs one
mate takes ``bad_read_low_share`` of low-quality bases, so that it fails the
filter's bad-base rule; ``n_read_share`` of the reads carry ``n_count`` Ns.

The sample's truth (each pair's source, start and strand, and the reads
themselves) stays in memory for the comparison that decides ``correct``.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

from .mitogenome import Mitogenome

LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


@dataclass
class ReadTruth:
    """Per pair (in file order): ``source`` 0 mitogenome, 1 nuclear;
    ``start`` of the fragment on its source; ``insert`` its length;
    ``swapped`` whether file read 1 is the fragment's reverse end. ``r1``,
    ``r2``: codes [n, L] (4 = N); ``q1``, ``q2``: Phred+33 bytes [n, L]."""

    source: np.ndarray
    start: np.ndarray
    insert: np.ndarray
    swapped: np.ndarray
    r1: np.ndarray
    r2: np.ndarray
    q1: np.ndarray
    q2: np.ndarray
    names: list


_ENC = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ENC[_c] = _i


def _codes(seq: str) -> np.ndarray:
    return _ENC[np.frombuffer(seq.encode(), dtype=np.uint8)]


def _fragments(rng, genome: np.ndarray, n: int, p: dict, circular: bool):
    L = p["read_len"]
    ins = np.clip(np.rint(rng.normal(p["insert_mean"], p["insert_sd"], n)), L,
                  None).astype(np.int64)
    G = len(genome)
    start = rng.integers(0, G, n) if circular else rng.integers(0, G - ins + 1)
    cols = np.arange(L)
    fwd = genome[(start[:, None] + cols[None, :]) % G]
    rev_pos = (start + ins - L)[:, None] + cols[None, :]
    rev = COMP[genome[rev_pos % G]][:, ::-1]
    return start, ins, fwd, rev


def _quals(rng, n: int, L: int, low_share) -> np.ndarray:
    low = rng.random((n, L)) < np.asarray(low_share, dtype=np.float64).reshape(-1, 1)
    q = np.where(low, rng.integers(2, 21, (n, L)), rng.integers(25, 41, (n, L)))
    return (q + 33).astype(np.uint8)


def _fastq_bytes(names, reads: np.ndarray, quals: np.ndarray) -> bytes:
    n, L = reads.shape
    w = len(names[0])
    rec = np.empty((n, w + 1 + L + 3 + L + 1), dtype=np.uint8)
    rec[:, :w] = np.frombuffer("".join(names).encode(), np.uint8).reshape(n, w)
    rec[:, w] = 10
    rec[:, w + 1:w + 1 + L] = LUT[reads]
    rec[:, w + 1 + L:w + 4 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, w + 4 + L:w + 4 + 2 * L] = quals
    rec[:, -1] = 10
    return rec.tobytes()


def generate(mito: Mitogenome, params: dict, seed: int, index: int, out_dir: str):
    """Sample ``index`` of the pool: writes ``r1.fq.gz`` and ``r2.fq.gz``
    under ``out_dir``; returns (inputs, input bases, truth)."""
    rng = np.random.default_rng([seed, index, 0x77677321])
    L = int(params["read_len"])
    genome = _codes(mito.genome)
    n_mito = len(genome) * int(params["mito_coverage"]) // (2 * L)
    nuc_len = int(params["nuclear_length"])
    n_nuc = nuc_len * int(params["nuclear_coverage"]) // (2 * L) if nuc_len else 0
    parts = [(0, _fragments(rng, genome, n_mito, params, True))]
    if n_nuc:
        nuclear = rng.integers(0, 4, nuc_len).astype(np.uint8)
        parts.append((1, _fragments(rng, nuclear, n_nuc, params, False)))
    source = np.concatenate([np.full(len(f[0]), s, np.int8) for s, f in parts])
    start = np.concatenate([f[0] for _, f in parts])
    ins = np.concatenate([f[1] for _, f in parts])
    fwd = np.concatenate([f[2] for _, f in parts])
    rev = np.concatenate([f[3] for _, f in parts])
    n = len(source)
    order = rng.permutation(n)
    source, start, ins, fwd, rev = source[order], start[order], ins[order], fwd[order], rev[order]
    swapped = rng.random(n) < 0.5
    r1 = np.where(swapped[:, None], rev, fwd)
    r2 = np.where(swapped[:, None], fwd, rev)
    for r in (r1, r2):
        sub = rng.random(r.shape) < float(params["substitution_rate"])
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    low = float(params["low_base_share"])
    bad_pair = rng.random(n) < float(params["bad_pair_share"])
    bad_mate = rng.integers(0, 2, n)
    bad_low = float(params["bad_read_low_share"])
    q1 = _quals(rng, n, L, np.where(bad_pair & (bad_mate == 0), bad_low, low))
    q2 = _quals(rng, n, L, np.where(bad_pair & (bad_mate == 1), bad_low, low))
    n_lo, n_hi = params["n_count"]
    for r in (r1, r2):
        rows = np.nonzero(rng.random(n) < float(params["n_read_share"]))[0]
        for row in rows:
            k = int(rng.integers(n_lo, n_hi + 1))
            r[row, rng.choice(L, size=k, replace=False)] = 4
    names = [f"@s{index:04d}_{i:08d}" for i in range(n)]
    os.makedirs(out_dir, exist_ok=True)
    level = int(params["gzip_level"])
    paths = {}
    for key, reads, quals in (("fastq1", r1, q1), ("fastq2", r2, q2)):
        path = os.path.join(out_dir, f"{'r1' if key == 'fastq1' else 'r2'}.fq.gz")
        with open(path, "wb") as f:
            f.write(gzip.compress(_fastq_bytes(names, reads, quals), compresslevel=level,
                                  mtime=0))
        paths[key] = path
    truth = ReadTruth(source, start, ins, swapped, r1, r2, q1, q2, names)
    return paths, 2 * n * L, truth
