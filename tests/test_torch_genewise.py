"""Parity of the port's genewise (mitoflex_tpu_torch.ops.genewise) with the
JAX package's, on the CPU.

The same proteins and DNA windows, made from a seed with numpy, go through
both ``genewise_align`` functions. Tolerances: coordinates (query and target
from / to) and the frameshift count exact; scores within 1e-4 absolute (both
sum the same float32 terms; XLA may contract a step's additions differently
from eager PyTorch). ``translate_windows`` is integer work: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.models import codon
from mitoflex_tpu.ops import genewise as jax_gw
from mitoflex_tpu_torch import convert
from mitoflex_tpu_torch.io import encoding
from mitoflex_tpu_torch.ops import genewise as port_gw

SCORE_TOL = 1e-4
TABLE = 5


def _orf(rng, n_codons):
    gc = codon.get_code(TABLE)
    codons = [c for c, a in sorted(gc.forward.items()) if a != "*"]
    return "".join(codons[int(i)] for i in rng.integers(0, len(codons), n_codons))


def _stop_codon():
    gc = codon.get_code(TABLE)
    return next(c for c, a in sorted(gc.forward.items()) if a == "*")


def _case(rng, kind):
    """(protein codes, window string): a gene in random flanks, edited."""
    n = int(rng.integers(30, 60))
    nt = _orf(rng, n)
    pep = codon.get_code(TABLE).translate_str(nt)
    mid = 3 * (n // 2)
    if kind == "plus1":
        nt = nt[:mid] + "A" + nt[mid:]
    elif kind == "minus1":
        nt = nt[:mid] + nt[mid + 1:]
    elif kind == "plus2":
        nt = nt[:mid] + "CA" + nt[mid:]
    elif kind == "stop":
        nt = nt[:mid] + _stop_codon() + nt[mid + 3:]
    elif kind == "mutated":
        arr = list(nt)
        for i in rng.integers(0, len(arr), 6):
            arr[int(i)] = "ACGT"[int(rng.integers(0, 4))]
        nt = "".join(arr)
    elif kind == "with_n":
        nt = nt[:mid] + "NNN" + nt[mid + 3:]
    left = "".join("ACGT"[int(i)] for i in rng.integers(0, 4, int(rng.integers(5, 40))))
    right = "".join("ACGT"[int(i)] for i in rng.integers(0, 4, int(rng.integers(5, 40))))
    return codon.aa_encode(pep), left + nt + right


def _batch(rng, kinds, pad_rows=0, pad_q=0, pad_t=0):
    cases = [_case(rng, k) for k in kinds]
    B = len(cases) + pad_rows
    Lq = max(len(q) for q, _ in cases) + pad_q
    Lt = max(len(t) for _, t in cases) + pad_t
    qa = np.full((B, Lq), codon.X_CODE, np.int8)
    ta = np.full((B, Lt), 4, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (q, t) in enumerate(cases):
        qa[i, : len(q)] = q
        ta[i, : len(t)] = encoding.encode(t)
        ql[i], tl[i] = len(q), len(t)
    return qa, ql, ta, tl


def _both(qa, ql, ta, tl, **kw):
    aa = jax_gw.translate_windows(ta, TABLE)
    np.testing.assert_array_equal(port_gw.translate_windows(ta, TABLE), aa)
    sub = codon.blosum62()
    want = jax_gw.genewise_align(jnp.asarray(qa), jnp.asarray(ql), jnp.asarray(aa),
                                 jnp.asarray(tl), jnp.asarray(sub), **kw)
    got = port_gw.genewise_align(torch.from_numpy(qa), torch.from_numpy(ql),
                                 torch.from_numpy(aa), torch.from_numpy(tl), sub, **kw)
    return convert.hits_to_numpy(want), convert.hits_to_numpy(got)


def _assert_equal(want, got):
    for f in ("q_from", "q_to", "t_from", "t_to", "n_shift"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=SCORE_TOL)


KINDS = ["clean", "plus1", "minus1", "plus2", "stop", "mutated", "with_n"]


@pytest.mark.parametrize("kind", KINDS)
def test_genewise_align_matches_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind) + 40)
    want, got = _both(*_batch(rng, [kind] * 5 + ["clean"]))
    _assert_equal(want, got)
    assert (want.score[:5] > 30).all()
    if kind in ("plus1", "minus1", "plus2"):
        assert (want.n_shift[:5] >= 1).all()
    if kind == "clean":
        assert (want.n_shift == 0).all()


def test_genewise_align_padded_batch_matches_jax_and_unpadded():
    """Rows of length 0 and columns past every length change nothing: the
    padded batch (the reference's power-of-two shapes) gives the JAX result,
    and the port gives the same on the unpadded batch."""
    rng = np.random.default_rng(77)
    kinds = ["clean", "plus1", "stop", "minus1", "mutated"]
    qa, ql, ta, tl = _batch(rng, kinds)
    rng = np.random.default_rng(77)
    qp, qlp, tp, tlp = _batch(rng, kinds, pad_rows=3, pad_q=9, pad_t=37)
    want, got = _both(qp, qlp, tp, tlp)
    _assert_equal(want, got)
    _, tight = _both(qa, ql, ta, tl)
    for f in tight._fields:
        np.testing.assert_array_equal(getattr(tight, f), getattr(got, f)[:5], err_msg=f)


def test_genewise_align_other_penalties_match_jax():
    rng = np.random.default_rng(91)
    want, got = _both(*_batch(rng, KINDS), gap_open=10.0, gap_extend=2.0,
                      fs_penalty=8.0, stop_penalty=12.0)
    _assert_equal(want, got)


def test_wise_hits_converter_roundtrip():
    rng = np.random.default_rng(5)
    want, _ = _both(*_batch(rng, ["clean", "plus1"]))
    back = convert.hits_to_numpy(convert.wise_hits_from_reference(want, device="cpu"))
    assert type(back).__name__ == "WiseHits"
    for f in want._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(want, f))
