"""The score kernel (csrc/sw_score.cu through ``ops.sw.sw_scores``) on a
CUDA card, against its plain version and against the path kernel's score,
and blastn's score-first route on the card against the CPU's.

The file imports no JAX, so it also runs on a machine with a card and no
JAX: ``python -m pytest --noconftest tests/test_torch_sw_score_card.py``.
Without a card its tests skip. The cases are
``kernel_cases.sw_score_cases``, the card-size ones included: the merge's
shape (a 16,033-base circle against 48 windows of 200-20,000 on both
strands, N runs) and the int32 extremes. Exact throughout: every score is
an integer below 2^24.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from mitoflex_tpu_torch.io.fasta import FastaRecord
from mitoflex_tpu_torch.models import blast, codon
from mitoflex_tpu_torch.ops import sw
from mitoflex_tpu_torch.testing import kernel_cases, synth

CASES = list(kernel_cases.sw_score_cases())
IDS = [c[0] for c in CASES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the score kernel has no CPU build")
    return torch.device("cuda")


def _launches(fn):
    before = sw.sw_scores.launches
    out = fn()
    torch.cuda.synchronize()
    return out, sw.sw_scores.launches - before


@pytest.mark.card
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_sw_scores_on_card_equal_the_plain_version_and_sw_align(cuda, case):
    """Bit for bit, in one launch: the kernel against ``sw_scores_plain`` on
    the card and against ``sw_align``'s score (the path kernel) on the same
    pairs padded into one batch."""
    args, go, ge = kernel_cases.score_tensors(CASES[case], cuda)
    got, launches = _launches(lambda: sw.sw_scores(*args, go, ge))
    assert launches == 1
    want = sw.sw_scores_plain(*args, go, ge)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        (got[got != want][:5], want[got != want][:5])
    _, q, ql, qi, t, offs, sub, _, _ = CASES[case]
    tl = np.diff(offs)
    tp = np.zeros((len(qi), max(int(tl.max()), 1)), np.int8)
    for b in range(len(qi)):
        tp[b, : tl[b]] = t[offs[b]: offs[b + 1]]
    hits = sw.sw_align(*(torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                         for x in (q[qi], ql[qi], tp, tl.astype(np.int32), sub)), go, ge)
    assert torch.equal(got.view(torch.int32), hits.score.view(torch.int32))


@pytest.mark.card
def test_out_of_range_pairs_score_nan_and_leave_the_rest(cuda):
    case = CASES[IDS.index("a shared query set")]
    args, go, ge = kernel_cases.score_tensors(case, cuda)
    q, ql, qi, t, offs, sub = args
    want = sw.sw_scores(*args, go, ge)
    bad_qi = qi.clone()
    bad_qi[[1, 4]] = torch.tensor([3, -1], device=cuda)
    bad_offs = offs.clone()
    bad_offs[8] = offs[7] - 1        # pair 7 ends before it starts
    bad_offs[-1] = t.numel() + 1     # the last pair past the targets
    got = sw.sw_scores(q, ql, bad_qi, t, bad_offs, sub, go, ge)
    nan = torch.isnan(got).cpu().numpy()
    assert np.flatnonzero(nan).tolist() == [1, 4, 7, len(qi) - 1]
    keep = torch.from_numpy(~nan).to(cuda)
    keep[8] = False                   # starts where pair 7 now ends
    assert torch.equal(got[keep], want[keep])


@pytest.mark.card
def test_bad_arguments_are_refused_before_a_launch(cuda):
    """An asymmetric table (BLOSUM62 as the port holds it), gap_extend >
    gap_open, a fraction, a best possible score at 2^24, a float query and
    a padded target array: ValueError, and no launch."""
    args, go, ge = kernel_cases.score_tensors(CASES[IDS.index("a shared query set")], cuda)
    q, ql, qi, t, offs, sub = args
    before = sw.sw_scores.launches
    for bad, what in (((q, ql, qi, t, offs, codon.blosum62()), "symmetric"),
                      ((*args[:5], sub * 10000), "best possible score"),
                      ((*args[:5], sub + 0.25), "integers"),
                      ((q.float(), ql, qi, t, offs, sub), "queries"),
                      ((q, ql, qi, t[None], offs, sub), "targets")):
        with pytest.raises(ValueError, match=what):
            sw.sw_scores(*bad, go, ge)
    with pytest.raises(ValueError, match="extend <= open"):
        sw.sw_scores(*args, 2.0, 7.0)
    assert sw.sw_scores.launches == before


def _draft(overlap):
    (cid, circle), contigs = synth.merge_draft(np.random.default_rng(1), overlap)
    rec = lambda n, s, m: FastaRecord(n, s, {"flag": 0, "multi": m, "len": len(s)})
    return [rec(cid, circle, 400.0)], [rec(n, s, 20.0) for n, s in contigs]


@pytest.mark.card
@pytest.mark.parametrize("overlap", [lambda c: synth.chance_copy(c[:54]), lambda c: c[:85]],
                         ids=["chance_row", "true_overlap"])
def test_blastn_on_card_equals_the_cpu(cuda, monkeypatch, overlap):
    """The merge's blastn on the card, with three more contigs that hold
    pieces of the circle: the CPU's frame, one score launch a call below
    the cap and one a piece above it (pieces of 500 window bases)."""
    picked, db = _draft(overlap)
    rng = np.random.default_rng(2)
    circle = picked[0].seq
    more = [FastaRecord(f"piece{i}", synth.random_genome(rng, 300) + circle[a: a + 200]
                        + synth.random_genome(rng, 300), {"flag": 0, "multi": 20.0, "len": 800})
            for i, a in enumerate((100, 600, 1100))]
    subjects = picked + db + more
    want = blast.blastn(picked, subjects, skip_self=True, device="cpu")
    got, launches = _launches(lambda: blast.blastn(picked, subjects, skip_self=True,
                                                   device=cuda))
    assert launches == 1
    pd.testing.assert_frame_equal(got, want)
    monkeypatch.setattr(blast, "_SCORE_BASES", 500)
    got, launches = _launches(lambda: blast.blastn(picked, subjects, skip_self=True,
                                                   device=cuda))
    assert launches >= 2
    pd.testing.assert_frame_equal(got, want)
