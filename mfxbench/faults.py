"""Faults planted under the timed path, to show that the comparison catches
them (``control.py`` on the card, ``tests/test_mfxbench_faults.py`` on the
CPU). Each is a wrapper put around one of the port's functions for the
length of a window; none of the benchmark's own runs plants one.

- ``filter_half``: the read filter drops the second half of every batch
  (half of the batch left out);
- ``depth_half``: the depth remap sees every other batch of reads (half of
  the batch left out, the mean taken over the rest);
- ``viterbi_half``: nhmmer's pass 1 scores the first half of each batch of
  windows and returns "no alignment" for the rest (half of the batch left
  out);
- ``viterbi_shift``: nhmmer's pass 1 returns every score a quarter of a bit
  high (an answer altered where it is produced);
- ``genewise_start_cut``: genewise's frameshift DP (G1) returns every
  alignment starting 30 codons later than it does (an answer altered where
  it is produced: a PCG annotated 90 nt short at its start, less what the
  start-codon search wins back).
"""

from __future__ import annotations

import importlib
import itertools

import torch

NEG = -1e30


def _filter_half(real):
    def run(*args, **kwargs):
        keep, h1, h2 = real(*args, **kwargs)
        keep = keep.clone()
        keep[keep.shape[0] // 2:] = False
        return keep, h1, h2
    return run


def _depth_half(real):
    def run(records, batches, *args, **kwargs):
        return real(records, itertools.islice(batches, 0, None, 2), *args, **kwargs)
    return run


def _viterbi_half(real):
    def run(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[:, out.shape[1] // 2:] = NEG
        return out
    return run


def _viterbi_shift(real):
    def run(*args, **kwargs):
        return real(*args, **kwargs) + 0.25
    return run


def _genewise_start_cut(real):
    def run(*args, **kwargs):
        hits = real(*args, **kwargs)
        return hits._replace(q_from=torch.minimum(hits.q_from + 30, hits.q_to),
                             t_from=torch.minimum(hits.t_from + 90, hits.t_to))
    return run


FAULTS = {
    "filter_half": ("mitoflex_tpu_torch.ops.filter", "filter_reads", _filter_half),
    "depth_half": ("mitoflex_tpu_torch.ops.mapper", "coverage_of_reads", _depth_half),
    "viterbi_half": ("mitoflex_tpu_torch.ops.phmm", "viterbi_scores_multi", _viterbi_half),
    "viterbi_shift": ("mitoflex_tpu_torch.ops.phmm", "viterbi_scores_multi", _viterbi_shift),
    "genewise_start_cut": ("mitoflex_tpu_torch.ops.genewise", "genewise_align",
                           _genewise_start_cut),
}


def plant(patches, name: str) -> None:
    """Put fault ``name`` in place (``patches.restore()`` takes it out)."""
    module, fn, make = FAULTS[name]
    patches.wrap(importlib.import_module(module), fn, make)
