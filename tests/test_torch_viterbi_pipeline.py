"""The layout of the Viterbi kernel (mitoflex_tpu_torch/csrc/viterbi.cu) on
the CPU: a numpy model of its order held against the plain versions and the
JAX package, and the layout chooser ``ops.phmm.viterbi_config``.

The kernel runs a row's model columns as a pipeline of stages (a warp of 32
lanes, K columns a lane), the warps of a block and the blocks of a cluster
in turn. Each stage computes its part of the closure alone (a doubling over
its own columns, the identity left of them; and for its right neighbour the
suffix maxima of its last W columns) and takes from its left neighbour the
last column's state of the previous step, the suffix maxima (banded) or the
running prefix (exact). ``pipeline_model`` does the same in numpy float32,
stage by stage and step by step; it is held bit for bit (scores as float32
bits, all four coordinates) against ``viterbi_scan_plain`` and
``viterbi_scores_multi_plain`` on every case of
``testing/kernel_cases.viterbi_cases`` at every band of VITERBI_BANDS and at
every layout the chooser picks, and for one case a band against the JAX
package's scans (scores within SCORE_TOL, as tests/test_torch_viterbi.py;
coordinates exact). The kernel itself runs only on a card, where
``chip_smoke.py`` holds it against the plain versions on the same cases at
the same layouts.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitoflex_tpu.ops import phmm as jax_phmm
from mitoflex_tpu_torch import kernels
from mitoflex_tpu_torch.kernels import KernelLimitError
from mitoflex_tpu_torch.ops import phmm as port_phmm
from mitoflex_tpu_torch.testing import kernel_cases

SCORE_TOL = 1e-4
CASES = list(kernel_cases.viterbi_cases())
SMS = 132  # an H100's SMs
NEG = np.float32(port_phmm.NEG)
NONE = np.float32(-np.inf)  # the closure's identity: below every value a cell holds
F32 = np.float32


def _rows(arrays, mlens, seqs, lens, models):
    """Per-row parameters of the rows ``models x windows`` (the kernel's row
    order, model-major): profile rows, model and window lengths, codes."""
    B, T = seqs.shape
    Lp = arrays["msc"].shape[1]
    mi = np.repeat(np.asarray(models), B)
    bi = np.tile(np.arange(B), len(models))
    n = np.clip(np.asarray(mlens)[mi], 0, Lp)
    t_end = np.clip(lens[bi], 0, T)
    return mi, bi, n, t_end


def pipeline_model(arrays, mlens, seqs, lens, band, scan, cfg, models=None):
    """Both passes in the kernel's order at layout ``cfg`` (a ViterbiConfig):
    scores pass -> [Mn, B] float32; scan pass -> for each model of
    ``models``, (score, seq_from, seq_to, hmm_from, hmm_to) of its windows."""
    Mn, Lp = arrays["msc"].shape[:2]
    B, T = seqs.shape
    models = list(range(Mn)) if models is None else list(models)
    mi, bi, n, t_end = _rows(arrays, mlens, seqs, lens, models)
    R = len(mi)
    W = port_phmm.closure_window(band, scores=not scan)
    exact = scan and W == 0
    K = cfg.cols
    S = 32 * K
    n_st = cfg.warps * cfg.cluster
    width = S * n_st
    cols = np.arange(width)
    inside = cols[None, :] < n[:, None]  # [R, width]

    def param(f):
        out = np.full((R, width), NEG, F32)
        out[:, :Lp] = arrays[f][mi]
        return np.where(inside, out, NEG).astype(F32)

    tmm, tim, tdm, tmi, tii, tmd, cdd = (param(f) for f in
                                         ("tmm", "tim", "tdm", "tmi", "tii", "tmd", "cdd"))
    cddp = np.zeros((R, width), F32)
    cddp[:, 1:] = cdd[:, :-1]
    msc = np.full((R, width, 4), NEG, F32)
    isc = np.full((R, width, 4), NEG, F32)
    msc[:, :Lp] = arrays["msc"][mi]
    isc[:, :Lp] = arrays["isc"][mi]
    entry = arrays["entry"][mi].astype(F32)[:, None]
    codes = seqs[bi].astype(np.int64)

    zeros = lambda: np.zeros((R, width), np.int32)  # noqa: E731
    M, I, D = (np.full((R, width), NEG, F32) for _ in range(3))
    Mts, Mjs, Its, Ijs, Dts, Djs = (zeros() for _ in range(6))
    bV = np.full((R, width), NEG, F32)
    bVts, bVjs, bVt = zeros(), zeros(), zeros()
    best = np.full(R, NEG, F32)

    def comb_right(lv, lp, rv, rp):
        """The rightmost maximum of (left, right): right on ties."""
        take = rv >= lv
        return np.where(take, rv, lv), [np.where(take, r, l) for l, r in zip(lp, rp)]

    for t in range(T):
        live = (t < t_end)[:, None]
        x = np.where(t < t_end, codes[:, t], 4)
        xv = (x < 4)[:, None]
        cx = np.clip(x, 0, 3)
        em = np.where(xv & inside, np.take_along_axis(msc, cx[:, None, None], 2)[..., 0], NEG)
        ei = np.where(xv & inside, np.take_along_axis(isc, cx[:, None, None], 2)[..., 0], NEG)
        em, ei = em.astype(F32), ei.astype(F32)
        # every stage's left state is its neighbour's of step t-1: the last
        # column's, or the fill (NEG, payload 0) left of column 0
        pM = np.concatenate([np.full((R, 1), NEG, F32), M[:, :-1]], 1)
        pI = np.concatenate([np.full((R, 1), NEG, F32), I[:, :-1]], 1)
        pD = np.concatenate([np.full((R, 1), NEG, F32), D[:, :-1]], 1)
        shr = lambda a: np.concatenate([np.zeros((R, 1), np.int32), a[:, :-1]], 1)  # noqa: E731
        pP = [shr(a) for a in (Mts, Mjs, Its, Ijs, Dts, Djs)]
        new = {}
        if scan:
            bst = np.broadcast_to(entry, (R, width)).astype(F32)
            ts = np.full((R, width), t, np.int32)
            js = np.broadcast_to((cols + 1).astype(np.int32), (R, width))
            for v, pts, pjs in ((pM + tmm, pP[0], pP[1]), (pI + tim, pP[2], pP[3]),
                                (pD + tdm, pP[4], pP[5])):
                take = v > bst
                bst, ts, js = np.where(take, v, bst), np.where(take, pts, ts), \
                    np.where(take, pjs, js)
            ivm, ivi = M + tmi, I + tii
            take_m = ivm >= ivi
            new["Its"], new["Ijs"] = np.where(take_m, Mts, Its), np.where(take_m, Mjs, Ijs)
            new["I"] = (ei + np.where(take_m, ivm, ivi)).astype(F32)
        else:
            bst = np.maximum(np.maximum(entry, pM + tmm), np.maximum(pI + tim, pD + tdm))
            ts = js = np.zeros((R, width), np.int32)
            new["I"] = (ei + np.maximum(M + tmi, I + tii)).astype(F32)
        new["M"] = (em + bst).astype(F32)
        new["Mts"], new["Mjs"] = ts.astype(np.int32), js.astype(np.int32)
        a = ((new["M"] + tmd) - cdd).astype(F32)
        newD = np.empty((R, width), F32)
        newDts, newDjs = zeros(), zeros()
        # the stages in order: each reads what its left neighbour posted
        left_suf = (np.full((R, max(W, 1)), NEG, F32), np.zeros((R, max(W, 1)), np.int32),
                    np.zeros((R, max(W, 1)), np.int32))
        carry = (np.full(R, NONE, F32), np.zeros(R, np.int32), np.zeros(R, np.int32))
        for s in range(n_st):
            sl = slice(s * S, (s + 1) * S)
            av, ats, ajs = a[:, sl], new["Mts"][:, sl], new["Mjs"][:, sl]
            if exact:
                # the lanes' own prefixes (left on ties), a warp scan of their
                # totals, then the carry; D from the prefix left of a column
                fv, fts, fjs = (x.reshape(R, 32, K).copy() for x in (av, ats, ajs))
                for k in range(1, K):
                    keep = ~(fv[:, :, k] > fv[:, :, k - 1])
                    for arr in (fv, fts, fjs):
                        arr[:, :, k] = np.where(keep, arr[:, :, k - 1], arr[:, :, k])
                xv2, xts, xjs = fv[:, :, K - 1].copy(), fts[:, :, K - 1].copy(), \
                    fjs[:, :, K - 1].copy()
                d = 1
                while d < 32:
                    yv = np.concatenate([np.full((R, d), NONE, F32), xv2[:, :-d]], 1)
                    yts = np.concatenate([np.zeros((R, d), np.int32), xts[:, :-d]], 1)
                    yjs = np.concatenate([np.zeros((R, d), np.int32), xjs[:, :-d]], 1)
                    take = (np.arange(32) >= d)[None] & (yv >= xv2)
                    xv2, xts, xjs = np.where(take, yv, xv2), np.where(take, yts, xts), \
                        np.where(take, yjs, xjs)
                    d *= 2
                pv = np.concatenate([np.full((R, 1), NONE, F32), xv2[:, :-1]], 1)
                pts = np.concatenate([np.zeros((R, 1), np.int32), xts[:, :-1]], 1)
                pjs = np.concatenate([np.zeros((R, 1), np.int32), xjs[:, :-1]], 1)
                take = (np.arange(32) == 0)[None] | (carry[0][:, None] >= pv)
                pv = np.where(take, carry[0][:, None], pv)
                pts = np.where(take, carry[1][:, None], pts)
                pjs = np.where(take, carry[2][:, None], pjs)
                Dv = np.empty((R, 32, K), F32)
                Dt, Dj = np.empty((R, 32, K), np.int32), np.empty((R, 32, K), np.int32)
                cp = cddp[:, sl].reshape(R, 32, K)
                for k in range(K):
                    Dv[:, :, k] = np.where(pv == NONE, NEG, pv) + cp[:, :, k]
                    Dt[:, :, k], Dj[:, :, k] = pts, pjs
                    keep = ~(fv[:, :, k] > pv)
                    fv[:, :, k] = np.where(keep, pv, fv[:, :, k])
                    fts[:, :, k] = np.where(keep, pts, fts[:, :, k])
                    fjs[:, :, k] = np.where(keep, pjs, fjs[:, :, k])
                    pv, pts, pjs = fv[:, :, k], fts[:, :, k], fjs[:, :, k]
                carry = (pv[:, 31].copy(), pts[:, 31].copy(), pjs[:, 31].copy())
                newD[:, sl] = Dv.reshape(R, S)
                newDts[:, sl], newDjs[:, sl] = Dt.reshape(R, S), Dj.reshape(R, S)
                continue
            # banded: the doubling over the stage's own columns and, for the
            # right neighbour, the suffix maxima of its last W columns
            fv, fp = av.copy(), [ats.copy(), ajs.copy()]
            bv, bp = av.copy(), [ats.copy(), ajs.copy()]
            d = 1
            while d < W:
                lv = np.concatenate([np.full((R, d), NONE, F32), fv[:, :-d]], 1)
                lp = [np.concatenate([np.zeros((R, d), np.int32), q[:, :-d]], 1) for q in fp]
                fv, fp = comb_right(lv, lp, fv, fp) if scan else (np.maximum(fv, lv), fp)
                rv = np.concatenate([bv[:, d:], np.full((R, d), NONE, F32)], 1)
                rp = [np.concatenate([q[:, d:], np.zeros((R, d), np.int32)], 1) for q in bp]
                bv, bp = comb_right(bv, bp, rv, rp) if scan else (np.maximum(bv, rv), bp)
                d *= 2
            # cm of column j-1 inside the stage, the left's suffix where the
            # window reaches past the stage's first column
            pv = np.concatenate([np.full((R, 1), NONE, F32), fv[:, :-1]], 1)
            pp = [np.concatenate([np.zeros((R, 1), np.int32), q[:, :-1]], 1) for q in fp]
            ev = np.full((R, S), NEG, F32)
            ep = [zeros()[:, :S], zeros()[:, :S]]
            ev[:, :W] = left_suf[0]
            ep[0][:, :W], ep[1][:, :W] = left_suf[1], left_suf[2]
            reach = (np.arange(S) < W)[None]
            if scan:
                take = reach & ~(pv >= ev)
                pv = np.where(take, ev, pv)
                pp = [np.where(take, e, q) for e, q in zip(ep, pp)]
            else:
                pv = np.where(reach, np.maximum(pv, ev), pv)
            newD[:, sl] = (pv + cddp[:, sl]).astype(F32)
            newDts[:, sl], newDjs[:, sl] = pp
            left_suf = (bv[:, S - W:].copy(), bp[0][:, S - W:].copy(), bp[1][:, S - W:].copy())
        upd = {"M": new["M"], "I": new["I"], "D": newD, "Mts": new["Mts"], "Mjs": new["Mjs"],
               "Dts": newDts, "Djs": newDjs}
        if scan:
            upd.update(Its=new["Its"], Ijs=new["Ijs"])
        M, I, D = (np.where(live, upd[f], old).astype(F32)
                   for f, old in (("M", M), ("I", I), ("D", D)))
        Mts, Mjs, Dts, Djs = (np.where(live, upd[f], old).astype(np.int32) for f, old in
                              (("Mts", Mts), ("Mjs", Mjs), ("Dts", Dts), ("Djs", Djs)))
        if scan:
            Its, Ijs = (np.where(live, upd[f], old).astype(np.int32)
                        for f, old in (("Its", Its), ("Ijs", Ijs)))
            better = live & inside & (M > bV)
            bV = np.where(better, M, bV)
            bVts, bVjs = np.where(better, Mts, bVts), np.where(better, Mjs, bVjs)
            bVt = np.where(better, t, bVt)
        else:
            best = np.where(live[:, 0], np.maximum(best, np.where(inside, M, NEG).max(1)), best)
    if not scan:
        return best.reshape(len(models), B)
    # the final pick: each stage's first maximum, then the stages in order
    # (the lowest column on equal values)
    v = np.full(R, NEG, F32)
    col, vts, vjs, vt = (np.zeros(R, np.int64) for _ in range(4))
    for s in range(n_st):
        sl = slice(s * S, (s + 1) * S)
        sv = np.where(inside[:, sl], bV[:, sl], NEG)
        c = np.argmax(sv, 1)  # numpy's argmax takes the first maximum
        ov = sv[np.arange(R), c]
        oc = c + s * S
        hit = inside[np.arange(R), oc] & (bV[np.arange(R), oc] == ov)
        ov = np.where(hit, ov, NEG)
        take = (ov > v) | ((ov == v) & (oc < col) & hit)
        v = np.where(take, ov, v)
        col = np.where(take, oc, col)
        vts = np.where(take, bVts[np.arange(R), oc], vts)
        vjs = np.where(take, bVjs[np.arange(R), oc], vjs)
        vt = np.where(take, bVt[np.arange(R), oc], vt)
    # a row whose every best is NEG keeps column 0 with zero payloads
    out = (v, vts, vt, vjs, col + 1)
    return [tuple(np.asarray(x).reshape(len(models), B)[i] for x in out)
            for i in range(len(models))]


def _layouts(Lp, band, scan):
    return port_phmm.viterbi_configs(Lp, port_phmm.closure_window(band, scores=not scan),
                                     scan, SMS)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_pipeline_model_is_bit_equal_to_the_plain_versions(case):
    name, arrays, mlens, seqs, lens = CASES[case]
    s, l = torch.from_numpy(seqs), torch.from_numpy(lens)
    stack = kernel_cases._profile(arrays, None, "cpu")
    Lp = arrays["msc"].shape[1]
    for band in kernel_cases.VITERBI_BANDS:
        want = port_phmm.viterbi_scores_multi_plain(stack, mlens.tolist(), s, l, band).numpy()
        for cfg in _layouts(Lp, band, scan=False):
            got = pipeline_model(arrays, mlens, seqs, lens, band, False, cfg)
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"scores, band {band}, layout {tuple(cfg)}")
        plain = [port_phmm.viterbi_scan_plain(kernel_cases._profile(arrays, m, "cpu"), s, l,
                                              int(L), band) for m, L in enumerate(mlens)]
        for cfg in _layouts(Lp, band, scan=True):
            got = pipeline_model(arrays, mlens, seqs, lens, band, True, cfg)
            for m, (g, w) in enumerate(zip(got, plain)):
                np.testing.assert_array_equal(_bits(g[0]), _bits(w.score.numpy()),
                                              err_msg=f"score, model {m}, band {band}, "
                                                      f"layout {tuple(cfg)}")
                for f, gf, wf in zip(port_phmm.HmmHits._fields[1:], g[1:], w[1:]):
                    np.testing.assert_array_equal(gf, wf.numpy(), err_msg=(
                        f"{f}, model {m}, band {band}, layout {tuple(cfg)}"))


def _case(prefix):
    return next(c for c in CASES if c[0].startswith(prefix))


def _jax_profile(arrays, m):
    pick = (lambda x: x) if m is None else (lambda x: x[m])
    return jax_phmm.DeviceProfile(*(jnp.asarray(pick(arrays[f]))
                                    for f in jax_phmm.DeviceProfile._fields[:-1]), 0)


@pytest.mark.parametrize("band,prefix", [(16, "Lp 2048, flat profile"),
                                         (10, "Lp 1024, L 255/256"),
                                         (0, "Lp 256, flat profile")])
def test_pipeline_model_matches_jax(band, prefix):
    """One case a band through the JAX package's scans: scores within
    SCORE_TOL, coordinates exact, at the chooser's spread layout."""
    name, arrays, mlens, seqs, lens = _case(prefix)
    Lp = arrays["msc"].shape[1]
    cfg = port_phmm.viterbi_config(Lp, 1, port_phmm.closure_window(band, scores=True),
                                   False, SMS)
    got = pipeline_model(arrays, mlens, seqs, lens, band, False, cfg)
    want = np.asarray(jax_phmm.viterbi_scores_multi(
        _jax_profile(arrays, None), jnp.asarray(mlens), jnp.asarray(seqs), jnp.asarray(lens),
        delete_band=band))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    cfg = port_phmm.viterbi_config(Lp, 1, port_phmm.closure_window(band, scores=False),
                                   True, SMS)
    got = pipeline_model(arrays, mlens, seqs, lens, band, True, cfg)
    for m, L in enumerate(mlens.tolist()):
        want = jax_phmm.viterbi_scan(_jax_profile(arrays, m), jnp.asarray(seqs),
                                     jnp.asarray(lens), L, delete_band=band)
        np.testing.assert_allclose(got[m][0], np.asarray(want.score), rtol=0, atol=SCORE_TOL)
        for f, g in zip(("seq_from", "seq_to", "hmm_from", "hmm_to"), got[m][1:]):
            np.testing.assert_array_equal(g, np.asarray(getattr(want, f)),
                                          err_msg=f"{f}, model {m}, band {band}")


# ------------------------------------------------------------ the chooser
LPS = sorted({64, 65, 96, 100, 127, 128, 129, 200, 255, 256, 257, 300, 511, 512, 513, 700,
              1000, 1023, 1024, 1025, 1500, 2000, 2047, 2048, 2049, 3000, 4095, 4096, 4097,
              5000, 6000, 8000, 8191, 8192} | {64 * i for i in range(1, 129)})
ROWS = (1, 2, 3, 7, 28, 32, 33, 34, 64, 132, 133, 512, 1000, 4096)


def _windows():
    out = set()
    for band in range(-1, 129):
        out.add((port_phmm.closure_window(band, scores=True), False))
        out.add((port_phmm.closure_window(band, scores=False), True))
    return sorted(out)


def test_closure_windows_cover_the_kernels_range():
    assert {w for w, _ in _windows()} == {0, 1, 2, 4, 8, 16, 32, 64, 128}


@pytest.mark.parametrize("window,scan", _windows())
def test_every_pick_fits_the_card(window, scan):
    """Every width 64 to 8192 and row count 1 to 4096 at 132 SMs: at most
    1024 threads (and the instantiation's bound), a cluster of at most 8,
    227 KB of shared memory, the row's columns covered, and a stage at least
    the window wide."""
    for Lp in LPS:
        for rows in ROWS:
            cfg = port_phmm.viterbi_config(Lp, rows, window, scan, SMS)
            what = f"Lp {Lp}, rows {rows}, window {window}: {tuple(cfg)}"
            assert cfg.cols in port_phmm.KERNEL_COLS, what
            assert cfg.threads <= min(1024, port_phmm.kernel_max_threads(cfg.cols)), what
            assert 1 <= cfg.cluster <= 8 and cfg.warps >= 1 and cfg.rows >= 1, what
            assert port_phmm.kernel_smem_bytes(cfg, window, scan) <= 232448, what
            assert cfg.stage_width * cfg.warps * cfg.cluster >= Lp, what
            assert cfg.stage_width >= window, what
            port_phmm.check_config(cfg, Lp, window, scan)


def test_few_rows_spread_over_a_cluster_and_many_rows_do_not():
    few = port_phmm.viterbi_config(2048, 3, 16, True, SMS)
    assert (few.cols, few.cluster) == (1, 8) and few.warps * few.cluster * 32 >= 2048
    many = port_phmm.viterbi_config(128, 22 * 512, 16, False, SMS)
    assert (many.warps, many.cluster) == (1, 1) and many.rows > 1  # a warp a row
    assert port_phmm.viterbi_config(2048, 512, 16, False, SMS).cols == port_phmm.ROW_COLS


def test_shapes_the_kernel_cannot_serve_raise():
    with pytest.raises(KernelLimitError, match="padded model length 8193"):
        port_phmm.viterbi_config(8193, 1, 16, True, SMS)
    with pytest.raises(KernelLimitError, match="closure window 512"):
        port_phmm.viterbi_config(2048, 1, port_phmm.closure_window(300, scores=False), True,
                                 SMS)
    for bad in ((0, 1, 16, True), (128, 0, 16, True), (128, 1, 0, False), (128, 1, 12, True)):
        with pytest.raises(ValueError):
            port_phmm.viterbi_config(*bad, SMS)
    with pytest.raises(ValueError, match="threads a block"):
        port_phmm.check_config(port_phmm.ViterbiConfig(4, 8, 2, 1), 2048, 16, True)
    with pytest.raises(ValueError, match="window 64 for a stage of 32"):
        port_phmm.check_config(port_phmm.ViterbiConfig(1, 1, 1, 1), 32, 64, True)
    with pytest.raises(ValueError, match="columns for Lp"):
        port_phmm.check_config(port_phmm.ViterbiConfig(1, 2, 1, 1), 128, 16, True)


def test_chooser_mirrors_the_source():
    """The Python layout limits and shared-memory formula are the source's
    (chip_smoke.py also holds ``kernel_smem_bytes`` equal to the library's
    ``mfx_viterbi_smem_bytes``)."""
    with open(os.path.join(kernels.CSRC_DIR, "viterbi.cu")) as f:
        src = f.read()
    assert "return K == 1 ? 512 : 256;" in src
    assert "return scan ? 8 + 2 * W : 3 + W;" in src
    assert f"kMaxT = {port_phmm.KERNEL_MAX_T + 1};" in src
    assert re.search(r"kMaxSmem = 232448;", src) and re.search(r"kMaxCluster = 8;", src)
    assert "P * R * ((int64_t)kDepth * slot_words(W, scan) * 8 + kCtlBytes)" in src
    assert f"kDepth = {port_phmm.KERNEL_DEPTH};" in src and port_phmm.KERNEL_DEPTH >= 2
    assert "kCtlBytes = 32;" in src
    for K in port_phmm.KERNEL_COLS:
        assert f"viterbi_kernel<{K}, SCAN, 16>" in src and f"viterbi_kernel<{K}, SCAN, 0>" in src
    # no block-wide barrier inside the step loop
    loop = src[src.index("for (int t = 0; active && t < t_end; ++t) {"):
               src.index("// ---- the final pick")]
    assert "__syncthreads" not in loop and ".sync()" not in loop
    assert "cudaLaunchKernelEx" in src and "cudaLaunchAttributeClusterDimension" in src


def test_a_forced_layout_is_checked_before_any_launch():
    name, arrays, mlens, seqs, lens = CASES[3]
    prof = kernel_cases._profile(arrays, 0, "cpu")
    with pytest.raises(ValueError, match="columns for Lp"):
        port_phmm._layout(torch.device("cpu"), 128, 1, 16, True, (1, 1, 1, 1))
    cfg = port_phmm._layout(torch.device("cpu"), 128, 1, 16, True, (4, 1, 1, 1))
    assert cfg == port_phmm.ViterbiConfig(4, 1, 1, 1)
    # on the CPU a forced layout changes nothing: the plain version runs
    s, l = torch.from_numpy(seqs), torch.from_numpy(lens)
    got = port_phmm.viterbi_scan(prof, s, l, int(mlens[0]), _config=(4, 1, 1, 1))
    for g, w in zip(got, port_phmm.viterbi_scan_plain(prof, s, l, int(mlens[0]))):
        assert torch.equal(g, w)
