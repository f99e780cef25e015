"""Parity of the port's profile-HMM Viterbi (mitoflex_tpu_torch.ops.phmm)
with the JAX package's (mitoflex_tpu.ops.phmm) on the CPU.

Tolerances: staged profiles, coordinates and the host helpers are compared
exactly. Scores are float32 sums of the same terms in the same order in both
packages, but XLA may fuse and contract the additions of a step differently
from eager PyTorch, so scores are held to 1e-4 bits absolute (a few float32
ulps at the scores' magnitude of tens of bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.io import encoding
from mitoflex_tpu.models import hmm as hmm_models
from mitoflex_tpu.ops import phmm as jax_phmm
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch.ops import phmm as port_phmm
from tests import synth

SCORE_TOL = 1e-4


def _models(rng, lens):
    return [hmm_models.profile_from_consensus(f"M{i}", synth.random_genome(rng, n))
            for i, n in enumerate(lens)]


def _windows(rng, models, B, T):
    """Random windows, some holding a mutated consensus of a model (plus and
    minus strand), some with N runs and short lengths."""
    seqs = rng.integers(0, 4, (B, T)).astype(np.int8)
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    for i in range(B):
        m = models[i % len(models)]
        c = encoding.encode(m.consensus.upper())
        if i % 3 == 1:
            c = np.asarray(encoding.revcomp(c))
        c = c.copy()
        c[rng.integers(0, len(c), 3)] = rng.integers(0, 4, 3)
        at = int(rng.integers(0, max(1, lens[i] - len(c))))
        seqs[i, at: at + len(c)] = c[: T - at]
    seqs[2, 10:20] = encoding.N
    lens[-1] = 0
    return seqs, lens


def test_stage_profile_and_converters_exact(rng):
    for hmm, pad in zip(_models(rng, (24, 150)), (32, 0)):
        want = convert.profile_to_numpy(jax_phmm.stage_profile(hmm, pad_to=pad))
        got_t = port_phmm.stage_profile(hmm, pad_to=pad, device="cpu")
        got = convert.profile_to_numpy(got_t)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        back = convert.profile_to_numpy(convert.profile_to_torch(
            jax_phmm.stage_profile(hmm, pad_to=pad), "cpu"))
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("delete_band", [16, 0])
def test_viterbi_scan_matches_jax(rng, delete_band):
    models = _models(rng, (40, 90))
    seqs, lens = _windows(rng, models, 7, 192)
    for hmm in models:
        jprof = jax_phmm.stage_profile(hmm)
        want = convert.hits_to_numpy(jax_phmm.viterbi_scan(
            jprof, jnp.asarray(seqs), jnp.asarray(lens), hmm.length,
            delete_band=delete_band))
        got = convert.hits_to_numpy(port_phmm.viterbi_scan(
            convert.profile_to_torch(jprof, "cpu"), torch.from_numpy(seqs),
            torch.from_numpy(lens), hmm.length, delete_band=delete_band))
        np.testing.assert_allclose(got.score, want.score, rtol=0, atol=SCORE_TOL)
        for f in ("seq_from", "seq_to", "hmm_from", "hmm_to"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert want.score.max() > 20  # the planted copies are found


@pytest.mark.parametrize("delete_band", [16, 0])
def test_viterbi_scores_multi_matches_jax(rng, delete_band):
    models = _models(rng, (20, 33, 61))
    seqs, lens = _windows(rng, models, 6, 160)
    jstack = jax_phmm.stack_profiles([jax_phmm.stage_profile(m) for m in models])
    mlens = [m.length for m in models]
    want = np.asarray(jax_phmm.viterbi_scores_multi(
        jstack, jnp.asarray(mlens, jnp.int32), jnp.asarray(seqs), jnp.asarray(lens),
        delete_band=delete_band))
    pstack = port_phmm.stack_profiles([port_phmm.stage_profile(m, device="cpu") for m in models])
    got = port_phmm.viterbi_scores_multi(pstack, mlens, torch.from_numpy(seqs),
                                         torch.from_numpy(lens), delete_band).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    single = port_phmm.viterbi_scores(port_phmm.stage_profile(models[1], device="cpu"),
                                      torch.from_numpy(seqs), torch.from_numpy(lens),
                                      models[1].length, delete_band).numpy()
    np.testing.assert_array_equal(single, got[1])


def test_host_helpers_are_the_reference(rng):
    seqs = rng.integers(0, 5, (9, 120)).astype(np.int8)
    sf = rng.integers(0, 60, 9)
    st = sf + rng.integers(0, 60, 9)
    np.testing.assert_array_equal(port_phmm.null2_bias_bits(seqs, sf, st),
                                  jax_phmm.null2_bias_bits(seqs, sf, st))
    tl, al = rng.integers(1, 900, 9), rng.integers(0, 900, 9)
    np.testing.assert_array_equal(port_phmm.length_correction_bits(tl, al),
                                  jax_phmm.length_correction_bits(tl, al))
    x = rng.normal(10, 5, 9)
    np.testing.assert_array_equal(port_phmm.evalue(x, -3.0, 0.7, 1e4),
                                  jax_phmm.evalue(x, -3.0, 0.7, 1e4))
