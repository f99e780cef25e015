"""Parity of the port's Smith-Waterman (mitoflex_tpu_torch.ops.sw) with the
JAX package's sw_align, and with its full-matrix numpy oracle
sw_align_numpy, on the CPU.

Tolerances: coordinates and path counts exact. Scores are float32 sums of
the same integer-valued terms; they are held to 1e-4 absolute because XLA
may contract a step's additions differently from eager PyTorch (with
integer substitution scores and gap costs they come out equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.io import encoding
from mitoflex_tpu.models import codon
from mitoflex_tpu.ops import sw as jax_sw
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch.ops import sw as port_sw

SCORE_TOL = 1e-4


def _pairs(rng, B, K, fill, qmax, tmax):
    """Queries and targets of random lengths; most targets hold a mutated
    copy of their query with an insertion and a deletion."""
    ql = rng.integers(8, qmax + 1, B).astype(np.int32)
    tl = rng.integers(8, tmax + 1, B).astype(np.int32)
    ql[0], tl[0] = qmax, tmax
    q = np.full((B, qmax), fill, np.int8)
    t = np.full((B, tmax), fill, np.int8)
    for i in range(B):
        qi = rng.integers(0, K - 1, ql[i]).astype(np.int8)
        ti = rng.integers(0, K - 1, tl[i]).astype(np.int8)
        if i % 4 != 3:
            core = np.concatenate([qi[: ql[i] // 2], rng.integers(0, K - 1, 3),
                                   qi[ql[i] // 2 + 2:]]).astype(np.int8)
            core[rng.integers(0, len(core), 2)] = rng.integers(0, K - 1, 2)
            at = int(rng.integers(0, max(1, tl[i] - len(core))))
            ti[at: at + len(core)] = core[: tl[i] - at]
        q[i, : ql[i]] = qi
        t[i, : tl[i]] = ti
    return q, ql, t, tl


@pytest.mark.parametrize("mode,gaps", [("nt", (7.0, 2.0)), ("nt", (11.0, 1.0)),
                                       ("aa", (12.0, 1.0))])
def test_sw_align_matches_jax(rng, mode, gaps):
    if mode == "nt":
        sub, K, fill = jax_sw.nucleotide_matrix(), 5, encoding.N
        np.testing.assert_array_equal(port_sw.nucleotide_matrix(), sub)
    else:
        sub, K, fill = codon.blosum62(), codon.NUM_AA, codon.X_CODE
    q, ql, t, tl = _pairs(rng, 9, K, fill, 70, 120)
    want = convert.hits_to_numpy(jax_sw.sw_align(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(t), jnp.asarray(tl),
        jnp.asarray(sub), *gaps))
    got = convert.hits_to_numpy(port_sw.sw_align(
        torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(t),
        torch.from_numpy(tl), sub, *gaps))
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=SCORE_TOL)
    for f in got._fields[1:]:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (want.n_gapopen > 0).any() and (want.score > 40).any()
    # wider padding (the reference's power-of-two buckets) changes nothing
    wide = convert.hits_to_numpy(port_sw.sw_align(
        torch.from_numpy(np.pad(q, ((0, 0), (0, 58)), constant_values=fill)),
        torch.from_numpy(ql),
        torch.from_numpy(np.pad(t, ((0, 0), (0, 8)), constant_values=fill)),
        torch.from_numpy(tl), torch.from_numpy(sub), *gaps))
    for a, b in zip(wide, got):
        np.testing.assert_array_equal(a, b)
    for i in range(3):
        s, qf, qt, tf, tt = jax_sw.sw_align_numpy(q[i, : ql[i]], t[i, : tl[i]], sub, *gaps)
        assert abs(got.score[i] - s) < SCORE_TOL
        assert (got.q_to[i], got.t_to[i]) == (qt, tt)
