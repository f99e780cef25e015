"""The hard cases of the genewise kernel (mitoflex_tpu_torch/testing/
kernel_cases.py ``genewise_cases``) through the JAX package's genewise_align
(mitoflex_tpu.ops.genewise), the port's plain version on the CPU and a numpy
model of the kernel's order of work, and the wiring of its CUDA kernel
(csrc/genewise.cu), which runs only on a card: there ``chip_smoke.py`` holds
it against the plain version on the same cases, bit for bit.

Tolerances, as in tests/test_torch_genewise.py: against the JAX package,
coordinates and frameshift counts exact and scores within SCORE_TOL (XLA may
contract a step's additions differently from eager PyTorch; with integer
scores they come out equal). The numpy model must give the plain version's
six fields bit for bit: every case has integer scores and penalties.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.ops import genewise as jax_gw
from mitoflex_tpu_torch import convert, kernels
from mitoflex_tpu_torch.models import codon
from mitoflex_tpu_torch.ops import genewise as port_gw
from mitoflex_tpu_torch.testing import kernel_cases

SCORE_TOL = 1e-4
CASES = list(kernel_cases.genewise_cases())
IDS = [c.name for c in CASES]


@functools.lru_cache(maxsize=None)
def _plain(case: int):
    c = CASES[case]
    return convert.hits_to_numpy(port_gw.genewise_align_plain(
        *kernel_cases.genewise_tensors(c, "cpu"), *c.penalties))


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_genewise_cases_match_jax(case):
    c = CASES[case]
    want = convert.hits_to_numpy(jax_gw.genewise_align(
        *(jnp.asarray(x) for x in (c.queries, c.q_lens, c.target_aa, c.t_lens)),
        jnp.asarray(codon.blosum62()), *c.penalties))
    got = _plain(case)
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=SCORE_TOL)
    for f in got._fields[1:]:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_kernel_order_model_is_bit_equal_to_the_plain_version(case):
    c = CASES[case]
    got = kernel_cases.genewise_kernel_model(
        c.queries, c.q_lens, c.target_aa, c.t_lens, codon.blosum62(), *c.penalties)
    want = _plain(case)
    for f, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=f)


def test_cases_cover_the_hard_shapes():
    """Query lengths on both sides of the kernel's lanes (4 columns) and
    strips (128) up to three strips, lengths 0 to 2 of both sequences, a
    frameshift of every step, in-frame stops, odd codes, both penalty sets,
    a gene planted twice, and the real-size hit."""
    q_lens = set(np.concatenate([c.q_lens for c in CASES]).tolist())
    assert {0, 1, 2, 3, 4, 5, 127, 128, 129, 255, 256, 257, 600} <= q_lens
    t_lens = set(np.concatenate([c.t_lens for c in CASES]).tolist())
    assert {0, 1, 2} <= t_lens and max(t_lens) >= 1900
    assert port_gw.KERNEL_STRIP == 128
    assert {c.penalties for c in CASES} == set(kernel_cases.GENEWISE_PENALTIES)
    assert any((c.target_aa == codon.STOP_CODE).any() for c in CASES)
    assert any(((c.queries < 0) | (c.queries >= codon.NUM_AA)).any()
               and ((c.target_aa < 0) | (c.target_aa >= codon.NUM_AA)).any() for c in CASES)
    for i, c in enumerate(CASES):
        hits = _plain(i)
        if c.name.startswith("every frameshift step"):
            # clean, +1, +2, -1, -2 (steps 3, 4, 5, 2, 1), stop, N, mutated, random
            assert hits.n_shift[:5].tolist() == [0, 1, 1, 1, 1]
            assert (hits.score[:8] > 100).all() and hits.score[8] < 50
        if "twice" in c.name:
            # the first of two equal copies: its end lies in the first half
            assert (hits.t_to < c.t_lens // 2).all() and (hits.score > 100).all()
        if "lengths of 0" in c.name:
            assert hits.score.tolist()[:3] == [0.0, 5.0, 10.0]
            assert (hits.score[3:] == 0).all() and (hits.t_to[3:] == 0).all()
        if "real size" in c.name:
            assert (hits.n_shift == 1).all() and (hits.q_to - hits.q_from > 500).all()


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    before = port_gw.genewise_align.launches
    for c in CASES[:4]:
        args = kernel_cases.genewise_tensors(c, "cpu")
        for g, w in zip(port_gw.genewise_align(*args, *c.penalties),
                        port_gw.genewise_align_plain(*args, *c.penalties)):
            assert torch.equal(g, w)
    assert port_gw.genewise_align.launches == before == 0


def test_kernel_arguments_are_checked():
    """What the kernel does not take is refused with a ValueError naming it
    (the check, shared with the SW kernel, runs before every launch on a
    card); other integer lengths and a matrix given as an array are
    converted."""
    q, ql, aa, tl, sub = kernel_cases.genewise_tensors(CASES[0], "cpu")

    def check(*args):
        return port_gw._check_inputs(*args, "genewise_align", "target_aa")

    ql32, tl32, sub32 = check(q, ql.to(torch.int64), aa, tl.to(torch.int16), codon.blosum62())
    assert ql32.dtype == tl32.dtype == torch.int32 and sub32.dtype == torch.float32
    assert torch.equal(ql32, ql) and torch.equal(tl32, tl) and torch.equal(sub32, sub)
    for args, what in (((q.to(torch.int32), ql, aa, tl, sub), "queries"),
                       ((q, ql, aa.T, tl, sub), "target_aa"),
                       ((q, ql, aa[:-1], tl, sub), "targets"),
                       ((q, ql.to(torch.float32), aa, tl, sub), "q_lens"),
                       ((q, ql, aa, tl[:-1], sub), "t_lens"),
                       ((q, ql, aa, tl, sub[:-1]), "submat")):
        with pytest.raises(ValueError, match=f"^genewise_align: .*{what}"):
            check(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        port_gw.genewise_align(*(x.to("meta") for x in (q, ql, aa, tl, sub)))


def test_kernel_source_is_in_the_library():
    """The kernel's strip width and scratch words are the wrapper's, its
    ring reaches the five bases a frameshift reads back plus the lane skew,
    and its shared memory fits the static 48 KB."""
    assert "genewise.cu" in kernels.SOURCES
    with open(os.path.join(kernels.CSRC_DIR, "genewise.cu")) as f:
        src = f.read()
    assert re.search(r'extern "C" int mfx_genewise_align\(', src)
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kCols"] * consts["kWarp"] == port_gw.KERNEL_STRIP
    assert re.search(r"constexpr int kStrip = kCols \* kWarp;", src)
    assert consts["kBoundaryWords"] == port_gw._BOUNDARY_WORDS == 3 * 4
    assert consts["kRing"] >= 7 and consts["kRing"] & (consts["kRing"] - 1) == 0
    assert 2 * consts["kRing"] * (port_gw.KERNEL_STRIP + 1) * 16 <= 48 * 1024
    assert "--use_fast_math" not in " ".join(kernels.compile_command("genewise.cu", "x.o"))
    assert kernels._lib is None
