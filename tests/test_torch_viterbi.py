"""The hard cases of both Viterbi passes (mitoflex_tpu_torch/testing/
kernel_cases.py ``viterbi_cases``) through the JAX package's scans
(mitoflex_tpu.ops.phmm) and the port's plain versions on the CPU, and the
wiring of their CUDA kernel (csrc/viterbi.cu), which runs only on a card:
there ``chip_smoke.py`` holds it against the plain versions on the same
cases, bit for bit.

Tolerances: coordinates exact; scores within SCORE_TOL bits, as in
tests/test_torch_phmm.py (the JAX package's one-hot emission matmul and
XLA's fusion of a step against the port's gather and eager order).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.ops import phmm as jax_phmm
from mitoflex_tpu_torch import kernels
from mitoflex_tpu_torch.ops import phmm as port_phmm
from mitoflex_tpu_torch.testing import kernel_cases

SCORE_TOL = 1e-4
CASES = list(kernel_cases.viterbi_cases())


def _jax_profile(arrays, m):
    pick = (lambda x: x) if m is None else (lambda x: x[m])
    return jax_phmm.DeviceProfile(*(jnp.asarray(pick(arrays[f]))
                                    for f in jax_phmm.DeviceProfile._fields[:-1]), 0)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_viterbi_cases_match_jax(case):
    name, arrays, mlens, seqs, lens = CASES[case]
    s, l = torch.from_numpy(seqs), torch.from_numpy(lens)
    stack = kernel_cases._profile(arrays, None, "cpu")
    for band in kernel_cases.VITERBI_BANDS:
        want = np.asarray(jax_phmm.viterbi_scores_multi(
            _jax_profile(arrays, None), jnp.asarray(mlens), jnp.asarray(seqs),
            jnp.asarray(lens), delete_band=band))
        got = port_phmm.viterbi_scores_multi(stack, mlens.tolist(), s, l, band).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL, err_msg=f"band {band}")
        for m, L in enumerate(mlens.tolist()):
            want = jax_phmm.viterbi_scan(_jax_profile(arrays, m), jnp.asarray(seqs),
                                         jnp.asarray(lens), L, delete_band=band)
            got = port_phmm.viterbi_scan(kernel_cases._profile(arrays, m, "cpu"), s, l, L,
                                         band)
            np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=0,
                                       atol=SCORE_TOL, err_msg=f"model {m} band {band}")
            for f in ("seq_from", "seq_to", "hmm_from", "hmm_to"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)),
                                              err_msg=f"{f}, model {m}, band {band}")


def test_cases_cover_the_hard_shapes():
    """Padded widths of one, two and four columns a thread, L < Lp and
    L == Lp, one window, rows of length 0 and of N, and found copies."""
    widths = {a["msc"].shape[1] for _, a, _, _, _ in CASES}
    assert {128, 1024, 2048} <= widths
    assert any((ml == a["msc"].shape[1]).any() and (ml < a["msc"].shape[1]).any()
               for _, a, ml, _, _ in CASES)
    assert any(s.shape[0] == 1 for _, _, _, s, _ in CASES)
    assert any((l == 0).any() for _, _, _, _, l in CASES)
    assert any((s == 4).all(axis=1).any() for _, _, _, s, _ in CASES)
    stack = kernel_cases._profile(CASES[0][1], None, "cpu")
    best = port_phmm.viterbi_scores_multi(stack, CASES[0][2].tolist(),
                                          torch.from_numpy(CASES[0][3]),
                                          torch.from_numpy(CASES[0][4]))
    assert float(best.max()) > 50  # the planted copies are found


@pytest.mark.parametrize("band", [16, 10, 3, 2, 1, 0, -1])
def test_closure_window_is_the_plain_doubling(band):
    """The kernel's window is the last shift of the plain versions' rounds."""
    for scores, b in ((True, max(band, 2)), (False, band)):
        shift = 1
        while shift < b:
            shift *= 2
        want = shift if (scores or b > 0) else 0
        assert port_phmm.closure_window(band, scores) == want


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    name, arrays, mlens, seqs, lens = CASES[3]
    s, l = torch.from_numpy(seqs), torch.from_numpy(lens)
    before = (port_phmm.viterbi_scan.launches, port_phmm.viterbi_scores_multi.launches)
    stack = kernel_cases._profile(arrays, None, "cpu")
    got = port_phmm.viterbi_scores_multi(stack, mlens.tolist(), s, l)
    assert torch.equal(got, port_phmm.viterbi_scores_multi_plain(stack, mlens.tolist(), s, l))
    prof = kernel_cases._profile(arrays, 0, "cpu")
    hits = port_phmm.viterbi_scan(prof, s, l, int(mlens[0]))
    for g, w in zip(hits, port_phmm.viterbi_scan_plain(prof, s, l, int(mlens[0]))):
        assert torch.equal(g, w)
    single = port_phmm.viterbi_scores(prof, s, l, int(mlens[0]))
    assert torch.equal(single, got[0])
    assert (port_phmm.viterbi_scan.launches,
            port_phmm.viterbi_scores_multi.launches) == before == (0, 0)


def test_kernel_arguments_are_checked():
    """What the kernel does not take is refused with a ValueError naming it
    (the check runs before every launch on a card)."""
    name, arrays, mlens, seqs, lens = CASES[3]
    prof = kernel_cases._profile(arrays, 0, "cpu")
    s, l = torch.from_numpy(seqs), torch.from_numpy(lens)
    port_phmm._check_inputs("scan", prof, (), s, l)
    with pytest.raises(ValueError, match="lengths"):
        port_phmm._check_inputs("scan", prof, (), s, l.to(torch.int64))
    with pytest.raises(ValueError, match="seqs"):
        port_phmm._check_inputs("scan", prof, (), s.to(torch.int32), l)
    with pytest.raises(ValueError, match="profile msc"):
        port_phmm._check_inputs("scan", prof._replace(msc=prof.msc.T), (), s, l)
    with pytest.raises(ValueError, match="profile entry"):
        port_phmm._check_inputs("scan", prof._replace(entry=prof.entry.reshape(1)), (), s, l)


def test_kernel_source_is_in_the_library():
    assert "viterbi.cu" in kernels.SOURCES
    with open(os.path.join(kernels.CSRC_DIR, "viterbi.cu")) as f:
        src = f.read()
    for fn in ("mfx_viterbi_scores", "mfx_viterbi_scan"):
        assert re.search(r'extern "C" int ' + fn + r"\(", src), fn
    assert "--use_fast_math" not in " ".join(kernels.compile_command("viterbi.cu", "x.o"))
