"""Base encoding shared by host I/O and device kernels.

Bases are encoded A=0, C=1, G=2, T/U=3, anything else (N, IUPAC ambiguity)
= 4. Code 4 never participates in k-mers or alignment scores; kernels mask
it. The 2-bit packing used by k-mer ops lives in ops/kmer.py.

This is the engine-wide replacement for the byte-string plumbing of the
reference (which passes ASCII FASTA/FASTQ between processes).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

_ENCODE_LUT = np.full(256, N, dtype=np.int8)
for ch, code in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
    _ENCODE_LUT[ord(ch)] = code
    _ENCODE_LUT[ord(ch.lower())] = code

_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.int8)  # A<->T, C<->G, N->N


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence → int8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    codes = np.asarray(codes)
    return _DECODE_LUT[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[np.asarray(codes)][::-1]


def revcomp_str(seq: str) -> str:
    return decode(revcomp(encode(seq)))


def gc_content(codes: np.ndarray) -> float:
    codes = np.asarray(codes)
    valid = codes < 4
    if not valid.any():
        return 0.0
    gc = np.logical_or(codes == C, codes == G)
    return float(gc.sum() / valid.sum())
