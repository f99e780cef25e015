"""The hard cases of the genewise kernel (mitoflex_tpu_torch/testing/
kernel_cases.py ``genewise_cases``) through the JAX package's genewise_align
(mitoflex_tpu.ops.genewise), the port's plain version on the CPU and a numpy
model of the kernel's order of work (``kernel_cases.genewise_kernel_model``:
stages, rounds that wrap through the scratch row, the hand-off slots, the
histories in registers and the packed path fields) at every layout its
chooser (``ops.genewise.genewise_config``) weighs; the chooser; and the
wiring of its CUDA kernel (csrc/genewise.cu on csrc/row_pipeline.cuh), which
runs only on a card: there ``chip_smoke.py`` holds it against the plain
version on the same cases at every layout, bit for bit.

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
from mitoflex_tpu_torch.ops import row_pipeline as rp
from mitoflex_tpu_torch.testing import kernel_cases

SCORE_TOL = 1e-4
CASES = list(kernel_cases.genewise_cases(card_size=False))
IDS = [c.name for c in CASES]


def _model_layouts(c) -> list:
    """The layouts the card's check forces on a case (every layout the
    chooser weighs at its widths, the wide instantiation, a wrapping one),
    one of each (columns, positions, stages, wide): how the stages split
    into warps and cluster blocks changes no order. The model takes seconds
    a layout at the long cases, so the real-size hit runs at the chooser's
    pick, packed and wide, and the case past 2^15, there for the packed
    halves, at the pick alone."""
    Lq, T = c.queries.shape[1], c.target_aa.shape[1]
    own = port_gw.genewise_config(Lq, T)
    if Lq >= kernel_cases.GENEWISE_LONG_LQ:
        return [own]
    if Lq >= 600:
        return [own, own._replace(wide=True)]
    cfgs = kernel_cases.pipeline_layouts(port_gw.genewise_configs(Lq, T), own)
    return list({(x.cols, x.rows, x.stages, x.wide): x for x in cfgs}.values())


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
    want = _plain(case)
    layouts = _model_layouts(c)
    assert layouts
    for cfg in layouts:
        got = kernel_cases.genewise_kernel_model(
            c.queries, c.q_lens, c.target_aa, c.t_lens, codon.blosum62(), *c.penalties,
            layout=cfg)
        for f, g, w in zip(want._fields, got, want):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=f"{f} at layout {tuple(cfg)}")


def test_cases_cover_the_hard_shapes():
    """Query lengths on both sides of the kernel's lanes and strips at 1, 2
    and 4 columns a lane, lengths 0 to 2 of both sequences, a frameshift of
    every step, in-frame stops, odd codes, both penalty sets, a gene planted
    twice, the real-size hit, a best alignment that starts past residue
    2^15, and the over-the-packing-limit case of the full list."""
    q_lens = set(np.concatenate([c.q_lens for c in CASES]).tolist())
    assert {0, 1, 2, 3, 4, 5, 127, 128, 129, 255, 256, 257, 600,
            kernel_cases.GENEWISE_LONG_LQ} <= q_lens
    t_lens = set(np.concatenate([c.t_lens for c in CASES]).tolist())
    assert {0, 1, 2} <= t_lens and max(t_lens) >= 1900
    assert rp.LANES * max(rp.KERNEL_COLS) == 128
    big = [c for c in kernel_cases.genewise_cases() if c.name not in set(IDS)]
    assert [c.queries.shape[1] for c in big] == [kernel_cases.GENEWISE_WIDE_LQ]
    assert not port_gw.genewise_packable(big[0].queries.shape[1], big[0].target_aa.shape[1])
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
        if "past 2^15" in c.name:
            assert hits.q_from[0] >= 1 << 15 and hits.score[0] > 0


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
        return rp.check_inputs(*args, "genewise_align", "target_aa")

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
    """The entry point, the shared pipeline header, and the constants the
    wrapper and the chooser mirror: the packing limit, the histories a cell
    reads back, the slot's words and the instantiations; no shared-memory
    rings of cells are left."""
    assert "genewise.cu" in kernels.SOURCES
    assert {"handoff.cuh", "row_pipeline.cuh"} <= set(kernels.HEADERS)
    with open(os.path.join(kernels.CSRC_DIR, "genewise.cu")) as f:
        src = f.read()
    assert re.search(r'extern "C" int mfx_genewise_align\(', src)
    assert re.search(r'extern "C" long long mfx_genewise_smem_bytes\(', src)
    assert '#include "row_pipeline.cuh"' in src
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kPackLimit"] == port_gw.KERNEL_PACK_LIMIT == 65535
    assert consts["kHist"] == 5 and consts["kEHist"] == 3
    assert re.search(r"static constexpr int N = WIDE \? 3 : 2;", src)
    assert re.search(r"static constexpr int kRowWords = 3 \* \(1 \+ N\);", src)
    assert re.search(r"static constexpr int kSlot = ROWS \* kRowWords;", src)
    assert port_gw.SLOT_WORDS == {False: 3 * (1 + 2), True: 3 * (1 + 3)}
    shapes = {(int(c), int(r)) for c, r in
              re.findall(r"case \d\d: return rp::launch<WiseRec<(\d), (\d), WIDE>>", src)}
    assert shapes == set(rp.KERNEL_SHAPES)
    assert "__shared__" not in src
    assert "--use_fast_math" not in " ".join(kernels.compile_command("genewise.cu", "x.o"))
    assert kernels._lib is None


def test_genewise_config_layouts_are_in_range():
    """Every pick is one the kernel can run, packs the path fields exactly
    where Lq and T fit 16 bits and is the cheapest of the layouts the
    chooser weighs, and the real-size and golden hits get as many stages as
    strips."""
    for Lq in (1, 100, 600, 33000, 65600):
        for T in (0, 40, 359, 1950):
            cfg = port_gw.genewise_config(Lq, T)
            port_gw.check_config(cfg, Lq, T, 22)
            assert cfg.wide == (Lq > port_gw.KERNEL_PACK_LIMIT), (Lq, T)
            cost = {c: c.steps(Lq, T) * port_gw.STEP_COST[(c.cols, c.rows)]
                    for c in port_gw.genewise_configs(Lq, T)}
            assert cost[cfg] == min(cost.values()), (Lq, T)
    golden = port_gw.genewise_config(100, 359)
    real = port_gw.genewise_config(600, 1950)
    assert (golden.cols, golden.stages) == (1, 4) and real.rounds(600) == 1
    assert real.stages >= -(-600 // real.stage_width)
    assert port_gw.genewise_config(100, 70000).wide
    with pytest.raises(ValueError, match="packed path fields"):
        port_gw.check_config(golden, 100, 70000, 22)
    slot = 9 * golden.rows
    assert port_gw.genewise_smem_bytes(golden, 22) \
        == (22 * 23 * 4 + 15) // 16 * 16 + golden.warps * (rp.KERNEL_DEPTH * (slot + slot % 2) * 8 + 64)
