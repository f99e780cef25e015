"""The hard cases of the Smith-Waterman kernel (mitoflex_tpu_torch/testing/
kernel_cases.py ``sw_cases``) through the JAX package's sw_align
(mitoflex_tpu.ops.sw), the port's plain version on the CPU and a numpy model
of the kernel's order of work (``kernel_cases.sw_kernel_model``: stages,
rounds that wrap through the scratch row, the hand-off slots and the packed
path fields) at every layout its chooser (``ops.sw.sw_config``) weighs;
the chooser itself; and the wiring of its CUDA kernel (csrc/sw.cu on
csrc/row_pipeline.cuh), which runs only on a card: there ``chip_smoke.py``
holds it against the plain version on the same cases at every layout, bit
for bit, the blastn-size and over-the-packing-limit cases included.

Tolerances, as in tests/test_torch_sw.py: against the JAX package,
coordinates and path counts exact and scores within SCORE_TOL (XLA may
contract a step's additions differently from eager PyTorch; with integer
scores they come out equal). The numpy model must give the plain version's
nine fields bit for bit: every case has integer scores and gap costs.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.ops import sw as jax_sw
from mitoflex_tpu_torch import convert, kernels
from mitoflex_tpu_torch.ops import row_pipeline as rp
from mitoflex_tpu_torch.ops import sw as port_sw
from mitoflex_tpu_torch.testing import kernel_cases

SCORE_TOL = 1e-4
CASES = list(kernel_cases.sw_cases(card_size=False))
IDS = [c[0] for c in CASES]


@functools.lru_cache(maxsize=None)
def _plain(case: int):
    args, go, ge = kernel_cases.sw_tensors(CASES[case], "cpu")
    return convert.hits_to_numpy(port_sw.sw_align_plain(*args, go, ge))


def _model_layouts(case) -> list:
    """The layouts the card's check forces on a case (every layout the
    chooser weighs at its widths, the wide instantiation, a wrapping one),
    one of each (columns, positions, stages, wide): how the stages split
    into warps and cluster blocks changes no order. The long case, which is
    there for the packed halves past 2^15, runs at the chooser's pick alone
    (the model takes seconds a layout there)."""
    _, q, _, t, _, _, _, _ = case
    Lq, Lt = q.shape[1], t.shape[1]
    own = port_sw.sw_config(Lq, Lt)
    if Lq >= kernel_cases.SW_LONG_LQ:
        return [own]
    cfgs = kernel_cases.pipeline_layouts(port_sw.sw_configs(Lq, Lt), own)
    return list({(c.cols, c.rows, c.stages, c.wide): c for c in cfgs}.values())


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_sw_cases_match_jax(case):
    name, q, ql, t, tl, sub, go, ge = CASES[case]
    want = convert.hits_to_numpy(jax_sw.sw_align(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t), jnp.asarray(tl),
        jnp.asarray(sub), go, ge))
    got = _plain(case)
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=SCORE_TOL)
    for f in got._fields[1:]:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_kernel_order_model_is_bit_equal_to_the_plain_version(case):
    name, q, ql, t, tl, sub, go, ge = CASES[case]
    want = _plain(case)
    layouts = _model_layouts(CASES[case])
    assert layouts
    for cfg in layouts:
        got = kernel_cases.sw_kernel_model(q, ql, t, tl, sub, go, ge, cfg)
        for f, g, w in zip(want._fields, got, want):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=f"{f} at layout {tuple(cfg)}")


def test_cases_cover_the_hard_shapes():
    """Query lengths on both sides of the kernel's lanes and strips at 1, 2
    and 4 columns a lane, empty rows, one column, odd codes, tied best
    cells, gaps, a best alignment that starts past column 2^15, and the
    blastn-size and over-the-packing-limit rows of the full list."""
    q_lens = set(np.concatenate([c[2] for c in CASES]).tolist())
    assert {0, 1, 3, 4, 5, 127, 128, 129, 255, 256, 257, kernel_cases.SW_LONG_LQ} <= q_lens
    assert rp.LANES * max(rp.KERNEL_COLS) == 128
    assert any((c[4] == 0).any() for c in CASES)
    assert any(c[1].shape[1] == 1 for c in CASES)
    assert any(((c[1] < 0) | (c[1] >= c[5].shape[0])).any() for c in CASES)
    assert {(c[6], c[7]) for c in CASES} >= {(12.0, 1.0), (7.0, 2.0), (11.0, 1.0), (3.0, 3.0)}
    gapped = 0
    for c in CASES:
        args, go, ge = kernel_cases.sw_tensors(c, "cpu")
        hits = port_sw.sw_align_plain(*args, go, ge)
        gapped += int((hits.n_gapopen > 0).sum())
        if "tandem" in c[0]:
            # the whole 48-column query matches at several target offsets
            assert hits.score[[0, 1, 3]].tolist() == [96.0] * 3
    assert gapped >= 10
    long = _plain(IDS.index(next(n for n in IDS if n.startswith(f"Lq {kernel_cases.SW_LONG_LQ}"))))
    assert long.q_from[0] >= 1 << 15 and long.n_cols[0] >= 8 and long.score[0] > 0
    big = [c for c in kernel_cases.sw_cases() if c[0] not in set(IDS)]
    assert [c[1].shape[1] for c in big] == [kernel_cases.SW_BLASTN_LQ, kernel_cases.SW_WIDE_LQ]
    assert big[0][3].shape[1] == 300
    assert not port_sw.sw_packable(big[1][1].shape[1], big[1][3].shape[1])


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    before = port_sw.sw_align.launches
    for case in CASES[:4]:
        args, go, ge = kernel_cases.sw_tensors(case, "cpu")
        for g, w in zip(port_sw.sw_align(*args, go, ge), port_sw.sw_align_plain(*args, go, ge)):
            assert torch.equal(g, w)
    assert kernel_cases.check_sw("cpu", card_size=False) == (len(CASES), len(CASES))
    assert port_sw.sw_align.launches == before == 0


def test_kernel_arguments_are_checked():
    """What the kernel does not take is refused with a ValueError naming it
    (the check runs before every launch on a card); other integer lengths
    and a matrix given as an array are converted."""
    args, _, _ = kernel_cases.sw_tensors(CASES[0], "cpu")
    q, ql, t, tl, sub = args
    def check(*args):
        return rp.check_inputs(*args, "sw_align")

    ql32, tl32, sub32 = check(q, ql.to(torch.int64), t, tl.to(torch.int16),
                              sub.numpy().astype(np.int32))
    assert ql32.dtype == tl32.dtype == torch.int32 and sub32.dtype == torch.float32
    assert torch.equal(ql32, ql) and torch.equal(sub32, sub)
    with pytest.raises(ValueError, match="queries"):
        check(q.to(torch.int32), ql, t, tl, sub)
    with pytest.raises(ValueError, match="targets"):
        check(q, ql, t.T, tl, sub)
    with pytest.raises(ValueError, match="targets"):
        check(q, ql, t[:-1], tl, sub)
    with pytest.raises(ValueError, match="q_lens"):
        check(q, ql.to(torch.float32), t, tl, sub)
    with pytest.raises(ValueError, match="t_lens"):
        check(q, ql, t, tl[:-1], sub)
    with pytest.raises(ValueError, match="submat"):
        check(q, ql, t, tl, sub[:-1])
    with pytest.raises(ValueError, match="unsupported device"):
        port_sw.sw_align(*(x.to("meta") for x in args), 12.0, 1.0)


def _consts(name: str) -> dict:
    with open(os.path.join(kernels.CSRC_DIR, name)) as f:
        src = f.read()
    return src, {k: int(v) for k, v in re.findall(r"constexpr (?:int|bool) (k\w+) = (\d+);",
                                                   src)}


def test_kernel_source_is_in_the_library():
    """The entry point, the pipeline header and the constants the wrapper and
    the chooser mirror: lanes, the block's threads, the cluster, the ring's
    depth, the control words, the packing limit, the slot's words and the
    instantiations."""
    assert "sw.cu" in kernels.SOURCES
    assert {"handoff.cuh", "row_pipeline.cuh"} <= set(kernels.HEADERS)
    src, consts = _consts("sw.cu")
    assert re.search(r'extern "C" int mfx_sw_align\(', src)
    assert re.search(r'extern "C" long long mfx_sw_smem_bytes\(', src)
    assert '#include "row_pipeline.cuh"' in src
    assert consts["kPackLimit"] == port_sw.KERNEL_PACK_LIMIT == 65535
    assert re.search(r"static constexpr int N = WIDE \? 6 : 3;", src)
    assert re.search(r"static constexpr int kRowWords = 2 \* \(1 \+ N\);", src)
    assert re.search(r"static constexpr int kSlot = ROWS \* kRowWords;", src)
    assert port_sw.SLOT_WORDS == {False: 2 * (1 + 3), True: 2 * (1 + 6)}
    shapes = {(int(c), int(r)) for c, r in
              re.findall(r"case \d\d: return rp::launch<SwRec<(\d), (\d), WIDE>>", src)}
    assert shapes == set(rp.KERNEL_SHAPES)
    assert {c for c, _ in shapes} == set(rp.KERNEL_COLS)
    rp_src, head = _consts("row_pipeline.cuh")
    assert head["kLanes"] == rp.LANES
    assert head["kMaxThreads"] == rp.KERNEL_MAX_THREADS == rp.LANES * rp.KERNEL_MAX_WARPS
    assert head["kMaxCluster"] == rp.KERNEL_MAX_CLUSTER
    assert head["kMaxSmem"] == rp.KERNEL_MAX_SMEM
    assert head["kCtlBytes"] == rp.KERNEL_CTL_BYTES
    assert head["kDepth"] == rp.KERNEL_DEPTH >= 2
    assert "(int64_t)P * ((int64_t)kDepth * ((slot + 1) & ~1) * 8 + kCtlBytes)" in rp_src
    assert "--use_fast_math" not in " ".join(kernels.compile_command("sw.cu", "x.o"))


# --------------------------------------------------------- the chooser
SHAPES = [(Lq, Lt) for Lq in (1, 33, 100, 257, 600, 2000, 16500, 33000, 65600)
          for Lt in (0, 16, 300, 1950, 5300)]


def test_sw_config_layouts_are_in_range():
    """Every pick is one the kernel can run (``check_config``), gives a pair
    no more stages than its query has strips, packs the path fields exactly
    where they fit, and is one of the layouts the chooser weighs, one an
    instantiation."""
    for Lq, Lt in SHAPES:
        cfg = port_sw.sw_config(Lq, Lt)
        port_sw.check_config(cfg, Lq, Lt, 25)
        strips = max(-(-Lq // cfg.stage_width), 1)
        assert (cfg.cols, cfg.rows) in rp.KERNEL_SHAPES
        assert 1 <= cfg.warps <= rp.KERNEL_MAX_WARPS
        assert cfg.cluster == 1 or cfg.stages <= strips + rp.KERNEL_MAX_WARPS - 1
        assert cfg.threads <= rp.KERNEL_MAX_THREADS
        assert cfg.wide == (Lq + Lt > port_sw.KERNEL_PACK_LIMIT), (Lq, Lt)
        weighed = port_sw.sw_configs(Lq, Lt)
        assert cfg in weighed
        assert [(c.cols, c.rows) for c in weighed] == list(rp.KERNEL_SHAPES)
        for c in weighed:
            port_sw.check_config(c, Lq, Lt, 25)


def test_sw_config_follows_the_call():
    """A long target: as many stages as strips at the columns a lane whose
    chain is shortest in the chooser's measured step costs (a step's
    latency is the call's time); a long query against a short target: four
    columns a lane (fewer strips to fill), wrapping round where the pair has
    fewer stages than strips. The pick is the cheapest layout weighed."""
    golden = port_sw.sw_config(100, 5163)
    assert (golden.cols, golden.stages, golden.wide) == (1, 4, False)
    assert golden.rounds(100) == 1
    # two positions a lane a step halve a long target's term of the chain;
    # a short target against a long query keeps one
    assert golden.rows == 2 and golden.steps(100, 5163) < 5163 // 2 + 200
    blastn = port_sw.sw_config(16500, 300)
    assert blastn.cols == 4 and blastn.cluster == rp.KERNEL_MAX_CLUSTER \
        and blastn.rounds(16500) > 1 and blastn.rows == 1
    real = port_sw.sw_config(600, 5300)
    assert (real.cols, real.rows, real.rounds(600)) == (1, 2, 1)
    for Lq, Lt in SHAPES:
        cost = {c: c.steps(Lq, Lt) * port_sw.STEP_COST[(c.cols, c.rows)]
                for c in port_sw.sw_configs(Lq, Lt)}
        assert cost[port_sw.sw_config(Lq, Lt)] == min(cost.values()), (Lq, Lt)


def test_wide_path_fields_above_the_packing_limit():
    """The wide instantiation is picked above Lq + Lt = 65,535 and only
    there; a packed layout forced above it is refused; the wide one is
    taken at any width."""
    assert not port_sw.sw_config(65535 - 200, 200).wide
    wide = port_sw.sw_config(65600, 200)
    assert wide.wide
    port_sw.check_config(wide, 65600, 200, 5)
    with pytest.raises(ValueError, match="packed path fields"):
        port_sw.check_config(wide._replace(wide=False), 65600, 200, 5)
    port_sw.check_config(port_sw.sw_config(100, 50)._replace(wide=True), 100, 50, 25)


def test_layouts_the_kernel_cannot_run_are_refused():
    good = port_sw.sw_config(300, 300)
    for bad, what in ((good._replace(cols=3), "columns a lane"),
                      (good._replace(cols=4, rows=2), "columns a lane at 2 positions"),
                      (good._replace(warps=5), "threads a block"),
                      (good._replace(cluster=9), "cluster"),
                      (good._replace(warps=0), "warps 0")):
        with pytest.raises(ValueError, match=what):
            port_sw.check_config(bad, 300, 300, 25)
    assert port_sw.sw_smem_bytes(good, 25) \
        == 2512 + good.warps * (8 * 8 * good.rows * 8 + 64)
    with pytest.raises(kernels.KernelLimitError, match="hand-off slots"):
        rp.choose(1 << 30, 1 << 21, True, port_sw.STEP_COST, "sw_align")
