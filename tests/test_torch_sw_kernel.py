"""The hard cases of the Smith-Waterman kernel (mitoflex_tpu_torch/testing/
kernel_cases.py ``sw_cases``) through the JAX package's sw_align
(mitoflex_tpu.ops.sw) and the port's plain version on the CPU, and the
wiring of its CUDA kernel (csrc/sw.cu), which runs only on a card: there
``chip_smoke.py`` holds it against the plain version on the same cases,
bit for bit, the blastn-size case included.

Tolerances, as in tests/test_torch_sw.py: coordinates and path counts
exact; scores within SCORE_TOL (XLA may contract a step's additions
differently from eager PyTorch; with integer scores they come out equal).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.ops import sw as jax_sw
from mitoflex_tpu_torch import convert, kernels
from mitoflex_tpu_torch.ops import sw as port_sw
from mitoflex_tpu_torch.testing import kernel_cases

SCORE_TOL = 1e-4
CASES = list(kernel_cases.sw_cases(blastn_size=False))


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_sw_cases_match_jax(case):
    name, q, ql, t, tl, sub, go, ge = CASES[case]
    want = convert.hits_to_numpy(jax_sw.sw_align(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t), jnp.asarray(tl),
        jnp.asarray(sub), go, ge))
    args, go, ge = kernel_cases.sw_tensors(CASES[case], "cpu")
    got = convert.hits_to_numpy(port_sw.sw_align_plain(*args, go, ge))
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=SCORE_TOL)
    for f in got._fields[1:]:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_cases_cover_the_hard_shapes():
    """Query lengths on both sides of the kernel's lanes (4 columns) and
    strips (128), empty rows, one column, odd codes, tied best cells, gaps,
    and the blastn-size row of the full list."""
    q_lens = set(np.concatenate([c[2] for c in CASES]).tolist())
    assert {0, 1, 3, 4, 5, 127, 128, 129, 255, 256, 257} <= q_lens
    assert port_sw.KERNEL_STRIP == 128
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
    big = [c for c in kernel_cases.sw_cases() if c[0] not in {x[0] for x in CASES}]
    assert len(big) == 1 and big[0][1].shape[1] >= 16384 and big[0][3].shape[1] == 300


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    before = port_sw.sw_align.launches
    for case in CASES[:4]:
        args, go, ge = kernel_cases.sw_tensors(case, "cpu")
        for g, w in zip(port_sw.sw_align(*args, go, ge), port_sw.sw_align_plain(*args, go, ge)):
            assert torch.equal(g, w)
    assert kernel_cases.check_sw("cpu", blastn_size=False) == len(CASES)
    assert port_sw.sw_align.launches == before == 0


def test_kernel_arguments_are_checked():
    """What the kernel does not take is refused with a ValueError naming it
    (the check runs before every launch on a card); other integer lengths
    and a matrix given as an array are converted."""
    args, _, _ = kernel_cases.sw_tensors(CASES[0], "cpu")
    q, ql, t, tl, sub = args
    ql32, tl32, sub32 = port_sw._check_inputs(q, ql.to(torch.int64), t, tl.to(torch.int16),
                                              sub.numpy().astype(np.int32))
    assert ql32.dtype == tl32.dtype == torch.int32 and sub32.dtype == torch.float32
    assert torch.equal(ql32, ql) and torch.equal(sub32, sub)
    with pytest.raises(ValueError, match="queries"):
        port_sw._check_inputs(q.to(torch.int32), ql, t, tl, sub)
    with pytest.raises(ValueError, match="targets"):
        port_sw._check_inputs(q, ql, t.T, tl, sub)
    with pytest.raises(ValueError, match="targets"):
        port_sw._check_inputs(q, ql, t[:-1], tl, sub)
    with pytest.raises(ValueError, match="q_lens"):
        port_sw._check_inputs(q, ql.to(torch.float32), t, tl, sub)
    with pytest.raises(ValueError, match="t_lens"):
        port_sw._check_inputs(q, ql, t, tl[:-1], sub)
    with pytest.raises(ValueError, match="submat"):
        port_sw._check_inputs(q, ql, t, tl, sub[:-1])
    with pytest.raises(ValueError, match="unsupported device"):
        port_sw.sw_align(*(x.to("meta") for x in args), 12.0, 1.0)


def test_kernel_source_is_in_the_library():
    assert "sw.cu" in kernels.SOURCES
    with open(os.path.join(kernels.CSRC_DIR, "sw.cu")) as f:
        src = f.read()
    assert re.search(r'extern "C" int mfx_sw_align\(', src)
    assert re.search(r"constexpr int kStrip = kCols \* kWarp;", src)
    assert "--use_fast_math" not in " ".join(kernels.compile_command("sw.cu", "x.o"))
