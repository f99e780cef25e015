"""local_extend's candidate budget (mitoflex_tpu_torch/stages/assemble.py):
round 1 keeps the reads that later rounds re-map only while their bytes fit
the budget, and stops collecting as soon as they pass it. The contigs are
the same whatever the budget, and the same as the JAX package's."""

import sys

import numpy as np
import pytest

from mitoflex_tpu.stages import assemble as jax_asm
from mitoflex_tpu_torch.io import encoding
from mitoflex_tpu_torch.stages import assemble as asm
from tests import synth

BATCHES = 6


def _fixture():
    """A 3000 bp genome, a contig that lacks 150 bp at each end (three
    rounds of 60 bases), and 100 bp reads every 3 bases in BATCHES batches
    in genome order."""
    g = synth.random_genome(np.random.default_rng(7), 3000)
    starts = list(range(0, len(g) - 100 + 1, 3))
    batches = []
    for part in np.array_split(np.asarray(starts), BATCHES):
        seqs = np.full((len(part), 128), 4, np.int8)
        lens = np.full(len(part), 100, np.int32)
        for i, s in enumerate(part):
            seqs[i, :100] = encoding.encode(g[s: s + 100])
        batches.append((seqs, lens))
    return g, g[150:2850], batches


def _held_at_each_batch(source, seen):
    """``source`` that notes, as each batch is asked for, how many candidate
    batches the caller (_extend_ends) holds: None once it dropped them."""
    def watched():
        for batch in source():
            held = sys._getframe(1).f_locals["candidates"]
            seen.append(None if held is None else len(held))
            yield batch
    return watched


def test_candidate_budget_stops_collection_and_keeps_the_contigs(monkeypatch):
    g, contig, batches = _fixture()

    def source():
        return iter(batches)

    def run():
        return asm.local_extend([asm.Contig(contig, 30.0, False)], source, device="cpu")

    def collect(seen):
        return asm._extend_ends([asm.Contig(contig, 30.0, False)],
                                _held_at_each_batch(source, seen), 3, 0.75, 60,
                                collect_candidates=True, device="cpu")[2]

    full = run()
    # three rounds were needed: a round re-mapped the candidates
    assert len(full) == 1 and len(full[0].seq) > len(contig) + 2 * 120
    assert full[0].seq in g
    want = jax_asm.local_extend([jax_asm.Contig(contig, 30.0, False)], source)
    assert [c.seq for c in full] == [c.seq for c in want]

    seen = []
    kept = collect(seen)
    assert len(kept) == BATCHES and seen == list(range(BATCHES))
    upto = np.cumsum([s.nbytes for s, _ in kept])
    assert 0 < upto[-1] <= asm.CAND_BUDGET_BYTES
    for budget in (0, int(upto[-1]) // 2):
        monkeypatch.setattr(asm, "CAND_BUDGET_BYTES", budget)
        seen = []
        assert collect(seen) is None
        # collection stopped at the first batch whose bytes passed the
        # budget, before the last batch was read, and held nothing after
        first_past = int(np.argmax(upto > budget))
        assert first_past < BATCHES - 1
        assert seen == list(range(first_past + 1)) + [None] * (BATCHES - first_past - 1)
        got = run()
        assert [(c.seq, c.depth, c.circular) for c in got] == \
            [(c.seq, c.depth, c.circular) for c in full]


@pytest.mark.parametrize("collect", [False, True])
def test_no_contigs_collects_nothing(collect):
    out, changed, cand = asm._extend_ends([], lambda: iter(()), 3, 0.75, 60,
                                          collect_candidates=collect, device="cpu")
    assert out == [] and changed is False
    assert cand == ([] if collect else None)
