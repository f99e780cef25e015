"""The frozen work formulas of ``work/`` against ``chip_smoke.py``'s, at
the golden shapes of PERF.md's kernel table: the same cells, bytes and
bound, and the bound PERF.md prints."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mfxbench import harness
from mfxbench.work import genewise_align, peaks, sw_align, viterbi, viterbi_scan, \
    viterbi_scores_multi


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_formulas", os.path.join(harness.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mfxbench_peaks_match(smoke):
    assert peaks.F32_OPS_PER_MS == smoke.F32_OPS_PER_MS
    assert peaks.HBM_BYTES_PER_MS == smoke.HBM_BYTES_PER_MS
    assert viterbi.VITERBI_OPS == smoke.VITERBI_OPS
    assert sw_align.SW_OPS_PER_CELL == smoke.SW_OPS_PER_CELL
    assert genewise_align.GENEWISE_OPS_PER_CELL == smoke.GENEWISE_OPS_PER_CELL


def test_mfxbench_k1_bytes(smoke):
    """K1 at 65536 x 256: 34.7 MB, 0.0103 ms."""
    B, L = 65536, 256
    args = (torch.zeros(B, L, dtype=torch.int8), torch.zeros(B, L, dtype=torch.int8),
            torch.zeros(B, dtype=torch.int32), 10, 55, 0.2, torch.zeros(B, dtype=torch.int32))
    out = (torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32),
           torch.zeros(B, dtype=torch.int32))
    rec = harness.work_modules()["filter_reads"].record(args, {}, out)
    ms, by = harness.work_modules()["filter_reads"].bound(rec)
    assert ms == pytest.approx(smoke._bound_ms(*args[:3], args[6], *out), rel=1e-12)
    assert round(rec["bytes"] / 1e6, 1) == 34.7 and round(ms, 4) == 0.0103 and by == "bytes"


@pytest.mark.parametrize("name", ["viterbi_scores_multi", "viterbi_scan"])
def test_mfxbench_viterbi_bound(smoke, name):
    """V1's golden largest call: 1 model, Lp 2048 (L 1100), 28 windows x T
    2200, 65,951,600 cells, bound 0.0187 ms; V2 on the same shape."""
    from mitoflex_tpu_torch.models import hmm
    from mitoflex_tpu_torch.ops import phmm

    model = hmm.profile_from_consensus("m", "ACGT" * 275)
    prof = phmm.stage_profile(model, device="cpu")
    seqs = torch.zeros(28, 2200, dtype=torch.int8)
    lengths = torch.tensor([2200] * 27 + [59_956 - 27 * 2200], dtype=torch.int32)
    if name == "viterbi_scores_multi":
        stack = phmm.stack_profiles([prof])
        rec = viterbi_scores_multi.record((stack, [1100], seqs, lengths), {}, None)
        want = smoke._viterbi_bound(name, stack, [1100], seqs, lengths, 16)
    else:
        rec = viterbi_scan.record((prof, seqs, lengths, 1100), {}, None)
        want = smoke._viterbi_bound(name, prof, [1100], seqs, lengths, 16)
    got = viterbi.bound(rec)
    assert got[0] == pytest.approx(want[0], rel=1e-12) and got[1] == want[1]
    assert want[2] == 65_951_600
    if name == "viterbi_scores_multi":
        assert round(got[0], 4) == 0.0187


def test_mfxbench_sw_and_genewise_bounds(smoke):
    """S1's golden call shape 48 x 100 x 5163 (24,782,400 cells, 0.0226 ms)
    and G1's 12 x 100 x 359 (430,800 cells, 0.00052 ms)."""
    sub = torch.zeros(24, 24, dtype=torch.float32)
    q, ql = torch.zeros(48, 100, dtype=torch.int8), torch.full((48,), 100)
    t, tl = torch.zeros(48, 5163, dtype=torch.int8), torch.full((48,), 5163)
    got = sw_align.bound(sw_align.record((q, ql, t, tl, sub), {}, None))
    want = smoke._sw_bound(q, ql, t, tl, sub)
    assert got[0] == pytest.approx(want[0], rel=1e-12) and want[2] == 24_782_400
    assert round(got[0], 4) == 0.0226
    q, ql = torch.zeros(12, 100, dtype=torch.int8), torch.full((12,), 100)
    aa, tl = torch.zeros(12, 359, dtype=torch.int8), torch.full((12,), 359)
    sub = np.zeros((24, 24), np.float32)
    got = genewise_align.bound(genewise_align.record((q, ql, aa, tl, sub), {}, None))
    want = smoke._genewise_bound(q, ql, aa, tl, sub)
    assert got[0] == pytest.approx(want[0], rel=1e-12) and want[2] == 430_800
    assert round(got[0], 5) == 0.00052
