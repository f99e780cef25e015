"""The hard cases of the banded CYK kernel (mitoflex_tpu_torch/testing/
kernel_cases.py ``cyk_cases``) through the JAX package's cyk_banded_device
(mitoflex_tpu.ops.cyk_device, one XLA program on the CPU) and the port's
plain version on the CPU, a numpy model of the kernel's order of
operations, and the wiring of its CUDA kernel (csrc/cyk.cu), which runs
only on a card: there ``chip_smoke.py`` holds it against the plain version
on the same cases, the CLEN-950 ones included.

Tolerances, as in tests/test_torch_cyk.py: window and model coordinates
exact; scores within CYK_SCORE_TOL bits (the IL / IR self-loops take float32
prefix sums, whose last bits depend on the order of summation). The numpy
model sums them in the kernel's order and must give the plain version's
maxima bit for bit.
"""

import inspect
import io
import os
import re

import numpy as np
import pytest
import torch

from mitoflex_tpu.models import cm as jax_cm
from mitoflex_tpu.ops import cyk_device as jax_dev
from mitoflex_tpu_torch import kernels
from mitoflex_tpu_torch.models import cmsearch
from mitoflex_tpu_torch.ops import cyk, cyk_device
from mitoflex_tpu_torch.testing import kernel_cases

CASES = list(kernel_cases.cyk_cases(golden_size=False))
IDS = [c.name for c in CASES]
NEG = np.float32(-1e30)
DEAD = np.float32(-3.0e4)


@pytest.fixture(scope="module")
def jax_models():
    return {k: jax_cm.parse_cm_text(io.StringIO(fx.text))[0]
            for k, fx in kernel_cases.cyk_fixtures(golden_size=False).items()}


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_cyk_cases_match_jax(case, jax_models):
    c = CASES[case]
    want = jax_dev.cyk_banded_device(jax_models[c.model_key], c.window, c.anchor, c.slack,
                                     local=c.local)
    got = cyk_device.cyk_banded_plain(kernel_cases.cyk_model(c.model_key), c.window,
                                      c.anchor, c.slack, c.local, device="cpu")
    kernel_cases.check_cyk(got, want, c.name)
    if "planted" in c.name:
        assert got is not None and (got.seq_from, got.seq_to) == c.anchor[:2]
    # the contract: host banded <= this <= exact, where the host has a parse
    host = cyk.cyk_banded(kernel_cases.cyk_model(c.model_key), c.window, c.anchor, c.slack,
                          local=c.local)
    if host is not None:
        assert got is not None and host.score <= got.score + kernel_cases.CYK_SCORE_TOL


def _kernel_model(x, order=None):
    """numpy model of csrc/cyk.cu's order: the step table, E states, tables
    and origins it reads, the E states first and then the step rows in the
    dispatch order (``order``, else the kernel's own, ``x.order``), every
    sum a float32 operation, the prefix sums left to right in float64
    rounded to float32 each, a state's maximum and first argmax. Returns
    (m, a)."""
    S, L, W = x.n_states, x.L, x.W
    steps = x.step_table.numpy()
    fsteps = steps.view(np.float32)
    single5, pair5 = x.single5.numpy(), x.pair5.numpy()
    geo = x.geo.numpy()
    o_i, o_j, codes = geo[:S], geo[S: 2 * S], geo[2 * S:]
    el_selfsc = np.float32(x.el_selfsc)
    r = np.arange(W)[:, None]
    c = np.arange(W)[None, :]
    deck = np.empty((S, W, W), np.float32)
    m = np.empty(S, np.float32)
    a = np.empty(S, np.int64)

    def finish(v, blk):
        ok = (c - r >= o_i[v] - o_j[v]) & (r < L - o_i[v] + 1) & (c < L - o_j[v] + 1)
        blk = np.where(ok, np.maximum(blk, NEG), NEG).astype(np.float32)
        deck[v] = blk
        m[v], a[v] = blk.max(), int(np.argmax(blk))

    def aligned(child, di, dj):
        rr, cc = r + di, c + dj
        inside = (rr >= 0) & (rr < W) & (cc >= 0) & (cc < W)
        return np.where(inside, deck[child][rr.clip(0, W - 1), cc.clip(0, W - 1)], NEG)

    done = np.zeros(S, bool)
    for v in x.e_states.numpy():
        deck[v] = np.where((o_i[v] + r == o_j[v] + c) & (o_j[v] + c <= L), np.float32(0), NEG)
        m[v], a[v] = deck[v].max(), int(np.argmax(deck[v]))
        done[v] = True
    for t in (x.order.numpy() if order is None else order):
        row, frow = steps[t], fsteps[t]
        v, kind = row[cyk_device._W_V], row[cyk_device._W_KIND]
        # the kernel waits for these flags: every child is done
        assert done[_children(row)].all()
        done[v] = True
        oiv, ojv = o_i[v], o_j[v]
        if kind < 0:
            lch, rch = row[cyk_device._W_LEFT], row[cyk_device._W_RIGHT]
            lb = aligned(lch, oiv - o_i[lch], 0)
            rb = aligned(rch, o_j[lch] - o_i[rch], ojv - o_j[rch])
            finish(v, (lb[:, :, None] + rb[None, :, :]).max(axis=1))
            continue
        si, sj = int(kind in (1, 3)), int(kind in (2, 3))
        ci, cj = codes[oiv + 1: oiv + 1 + W], codes[ojv: ojv + W]
        x_ = np.full((W, W), NEG, np.float32)
        for k in range(row[cyk_device._W_NKIDS]):
            kid = row[cyk_device._W_KID + k]
            x_ = np.maximum(x_, aligned(kid, oiv + si - o_i[kid], ojv - sj - o_j[kid])
                            + frow[cyk_device._W_T + k])
        flags = row[cyk_device._W_FLAGS]
        if flags & cyk_device.HAS_END:
            span = c - r + (ojv - sj - oiv - si)
            el = np.where((span >= 0) & (c < L - (ojv - sj) + 1),
                          span.astype(np.float32) * el_selfsc, NEG)
            x_ = np.maximum(x_, el + frow[cyk_device._W_END])
        em = None
        if kind == 1:
            em = single5[v][ci]
            x_ = x_ + em[:, None]
        elif kind == 2:
            em = single5[v][cj]
            x_ = x_ + em[None, :]
        elif kind == 3:
            x_ = x_ + pair5[v][ci[:, None] * 5 + cj[None, :]]
        if flags & cyk_device.HAS_SELF and kind in (1, 2):
            d = np.maximum(em + frow[cyk_device._W_SELF], DEAD)
            pre = np.empty(W, np.float32)
            acc = 0.0
            for k in range(W):
                if kind == 1:
                    pre[k] = np.float32(acc)
                    acc += float(d[k])
                else:
                    acc += float(d[k])
                    pre[k] = np.float32(acc)
            run = np.full(W, -np.inf, np.float32)
            if kind == 1:
                for rr in range(W - 1, -1, -1):
                    run = np.maximum(run, x_[rr] + pre[rr])
                    x_[rr] = run - pre[rr]
            else:
                for cc in range(W):
                    run = np.maximum(run, x_[:, cc] - pre[cc])
                    x_[:, cc] = run + pre[cc]
        finish(v, x_)
    return m, a


def _children(row):
    """The states a step row's state reads: a B state's two children, or a
    regular state's children (its self-loop aside)."""
    if row[cyk_device._W_KIND] < 0:
        return [row[cyk_device._W_LEFT], row[cyk_device._W_RIGHT]]
    return list(row[cyk_device._W_KID: cyk_device._W_KID + row[cyk_device._W_NKIDS]])


def _levels(model):
    """Each state's level, from the model's own tables (not the step
    table): 0 for an E state, else 1 more than the highest level of the
    states it reads (a B state's two children, a regular state's children
    but itself), found by a depth-first walk from every state."""
    from mitoflex_tpu_torch.models.cm import B, E

    level = {}

    def walk(v):
        stack = [v]
        while stack:
            u = stack[-1]
            if u in level:
                stack.pop()
                continue
            if model.stype[u] == E:
                kids = []
            elif model.stype[u] == B:
                kids = [int(model.cfirst[u]), int(model.cnum[u])]
            else:
                kids = [k for k in range(int(model.cfirst[u]),
                                         int(model.cfirst[u]) + int(model.cnum[u])) if k != u]
            todo = [k for k in kids if k not in level]
            if todo:
                stack.extend(todo)
            else:
                level[u] = 1 + max((level[k] for k in kids), default=-1)
                stack.pop()

    for v in range(model.n_states):
        walk(v)
    return np.array([level[v] for v in range(model.n_states)])


SCHEDULE_MODELS = [("trna", False), ("trna", True), ("rrna_180", False), ("rrna_180", True),
                   ("rrna_950", True)]


@pytest.mark.parametrize("key,local", SCHEDULE_MODELS,
                         ids=[f"{k} {'local' if lc else 'glocal'}" for k, lc in SCHEDULE_MODELS])
def test_dispatch_order_is_topological_and_complete(key, local):
    """The kernel takes the E states and then the step rows in its dispatch
    order: every state comes once, and every child before its parent."""
    model = kernel_cases.cyk_model(key)
    st = cyk_device._model_static(model, local, torch.device("cpu"))
    table = cyk_device._step_table(st["steps"])
    order, depth = cyk_device._schedule(table, model.n_states)
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(len(table)))
    e = st["e_states"].numpy()
    states = np.concatenate([e, table[order, cyk_device._W_V]])
    assert sorted(states.tolist()) == list(range(model.n_states))
    pos = np.empty(model.n_states, np.int64)
    pos[states] = np.arange(model.n_states)
    for t in order:
        assert (pos[_children(table[t])] < pos[table[t, cyk_device._W_V]]).all()
    # level by level: a row never comes after a row of a higher level
    lv = _levels(model)
    assert (np.diff(lv[table[order, cyk_device._W_V]]) >= 0).all()
    assert depth == lv.max() + 1


def test_schedule_depth_is_the_level_count():
    """The CLEN-950 fixture model (the golden run's size): the schedule's
    depth equals the levels counted from the model's tables, and is a
    small share of its states, which is what the kernel's dataflow gains."""
    model = kernel_cases.cyk_model("rrna_950")
    x = cyk_device.kernel_inputs(model, np.zeros(1078, np.int64), (64, 1013, 0, 949), 48, True,
                                 "cpu")
    lv = _levels(model)
    assert x.depth == len(np.unique(lv)) == lv.max() + 1
    assert x.depth < model.n_states // 5
    assert (np.bincount(lv) >= 1).all()


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_kernel_model_in_another_topological_order_is_bit_equal(case):
    """The dataflow runs a level's states in any order and at once: the
    numpy model of the kernel run level by level with each level reversed
    gives the plain version's maxima bit for bit and its argmax cells."""
    c = CASES[case]
    model = kernel_cases.cyk_model(c.model_key)
    want = cyk_device.cyk_banded_maxima_plain(model, c.window, c.anchor, c.slack, c.local,
                                              device="cpu")
    x = cyk_device.kernel_inputs(model, c.window, c.anchor, c.slack, c.local, "cpu")
    lv = _levels(model)[x.step_table.numpy()[:, cyk_device._W_V]]
    other = np.concatenate([np.flatnonzero(lv == k)[::-1] for k in np.unique(lv)])
    assert not np.array_equal(other, x.order.numpy())
    m, a = _kernel_model(x, other)
    assert np.array_equal(m.view(np.int32), want.m.view(np.int32))
    assert np.array_equal(a, want.a)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_kernel_order_model_is_bit_equal_to_the_plain_version(case):
    """The kernel's order of operations, modelled in numpy on the kernel's
    own inputs, gives the CPU plain version's maxima bit for bit and its
    argmax cells exactly."""
    c = CASES[case]
    want = cyk_device.cyk_banded_maxima_plain(kernel_cases.cyk_model(c.model_key), c.window,
                                              c.anchor, c.slack, c.local, device="cpu")
    m, a = _kernel_model(cyk_device.kernel_inputs(kernel_cases.cyk_model(c.model_key), c.window,
                                                 c.anchor, c.slack, c.local, "cpu"))
    assert np.array_equal(m.view(np.int32), want.m.view(np.int32))
    assert np.array_equal(a, want.a)
    kernel_cases.check_cyk(cyk_device.BandedMaxima(m, a, want.o_i, want.o_j), want, c.name)


def test_cases_cover_the_hard_kinds():
    """Every kind of window, the tRNA-size model at slack 8, 12 and 48,
    both modes, the truncation clamp taken, a window shorter than W, a tie
    between two copies, and a case without a parse; the full list adds the
    CLEN-950 model."""
    kinds = {c.name.split()[1] for c in CASES}
    assert kinds == {"planted", "mutated", "with_n", "truncated", "twice", "short", "junk",
                     "all_n"}
    assert {c.slack for c in CASES if c.model_key == "trna"} == {8, 12, 48}
    assert {c.model_key for c in CASES} == {"trna", "rrna_180"}
    assert {c.local for c in CASES} == {False, True}
    assert any(len(c.window) + 1 < 2 * c.slack + 2 for c in CASES)
    assert any((c.window >= 4).any() for c in CASES)
    clamped, parses = 0, {}
    for c in CASES:
        model = kernel_cases.cyk_model(c.model_key)
        got = cyk_device.cyk_banded_device(model, c.window, c.anchor, c.slack, c.local, "cpu")
        if "truncated" in c.name and c.local:
            # the parse runs to the window's end; mdl_to is clamped to hmm_to
            assert got.seq_to == len(c.window) - 1
            assert got.mdl_to == c.anchor[3] + 1 < model.clen
            clamped += 1
        if "twice" in c.name:
            # two equal parses: the first copy wins
            n = model.clen
            assert (got.seq_from, got.seq_to) == (20, 20 + n - 1)
        parses[c.name] = None if got is None else got.score
    assert clamped == 2
    # one case without a parse
    assert [k for k, v in parses.items() if v is None] == ["trna all_n slack 12 glocal"]
    # in glocal mode a window whose consensus holds N residues is parsed
    # through clipped self-loop steps (-3e4 each): there one float32 unit is
    # 0.004 bits or more, which is why check_cyk widens its tolerance there
    for name, score in parses.items():
        assert (score is not None and score < -3e4) == ("with_n" in name and "glocal" in name)
    assert kernel_cases.cyk_score_tol(-6e4) > 10 * kernel_cases.CYK_SCORE_TOL
    assert kernel_cases.cyk_score_tol(300.0) == kernel_cases.CYK_SCORE_TOL
    full = list(kernel_cases.cyk_cases())
    assert [c.name for c in full[: len(CASES)]] == IDS
    assert {c.model_key for c in full[len(CASES):]} == {"rrna_950"}
    assert kernel_cases.cyk_fixtures()["rrna_950"].clen == 950


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    before = cyk_device.cyk_banded_device.launches
    for c in CASES[:6]:
        model = kernel_cases.cyk_model(c.model_key)
        got = cyk_device.cyk_banded_device(model, c.window, c.anchor, c.slack, c.local, "cpu")
        want = cyk_device.cyk_banded_plain(model, c.window, c.anchor, c.slack, c.local, "cpu")
        assert got == want
        r = cyk_device.cyk_banded_maxima(model, c.window, c.anchor, c.slack, c.local, "cpu")
        p = cyk_device.cyk_banded_maxima_plain(model, c.window, c.anchor, c.slack, c.local,
                                               "cpu")
        for f in r._fields:
            assert np.array_equal(getattr(r, f), getattr(p, f))
    assert cyk_device.cyk_banded_device.launches == before == 0


def test_kernel_arguments_are_checked():
    """An over-limit band width raises KernelLimitError naming the width and
    the limit, a negative slack and a device that is neither the CPU nor a
    card raise ValueError naming them; nothing falls back."""
    c = CASES[0]
    model = kernel_cases.cyk_model(c.model_key)
    assert cyk_device.check_kernel_width(48) == 98
    assert cyk_device.check_kernel_width((cyk_device.KERNEL_MAX_W - 2) // 2) == \
        cyk_device.KERNEL_MAX_W
    for slack in ((cyk_device.KERNEL_MAX_W - 2) // 2 + 1, 100):
        with pytest.raises(cyk_device.KernelLimitError,
                           match=f"band width {2 * slack + 2} .* limit of "
                                 f"{cyk_device.KERNEL_MAX_W}"):
            cyk_device.check_kernel_width(slack)
        with pytest.raises(cyk_device.KernelLimitError, match="band width"):
            cyk_device.kernel_inputs(model, c.window, c.anchor, slack, c.local, "cpu")
    with pytest.raises(ValueError, match="negative slack -1"):
        cyk_device.check_kernel_width(-1)
    with pytest.raises(ValueError, match="negative slack"):
        cyk_device.kernel_inputs(model, c.window, c.anchor, -1, c.local, "cpu")
    for fn in (cyk_device.cyk_banded_device, cyk_device.cyk_banded_maxima):
        with pytest.raises(ValueError, match="unsupported device meta"):
            fn(model, c.window, c.anchor, c.slack, c.local, "meta")


def test_kernel_width_limit_is_no_value_error():
    """The kernel's width limit is an error of its own, which the rRNA
    search's refine does not take for the band check's refusal."""
    with pytest.raises(cyk_device.KernelLimitError) as err:
        cyk_device.check_kernel_width(64)
    assert not isinstance(err.value, ValueError)
    assert isinstance(err.value, RuntimeError)
    assert "band width 130" in str(err.value) and "128" in str(err.value)


def _refine_inputs():
    """(model, contig, p7 hit) of the planted tRNA-size case: the window as
    a contig, the hit on its anchor."""
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.io.fasta import FastaRecord
    from mitoflex_tpu_torch.models import cmsearch

    c = next(c for c in CASES if c.name == "trna planted slack 12 local")
    model = kernel_cases.cyk_model(c.model_key)
    rec = FastaRecord("w", encoding.decode(np.asarray(c.window)), {})
    hit = cmsearch.CmHit("w", 30.0, 1e-5, c.anchor[0] + 1, c.anchor[1] + 1, True,
                         c.anchor[2] + 1, c.anchor[3] + 1)
    return model, rec, hit


@pytest.mark.parametrize("error", ["width limit", "band check"])
def test_refine_lets_the_width_limit_propagate(error, monkeypatch):
    """A backend that refuses the width (as the card's does for W > 128)
    fails the refine loudly; the band check's ValueError still keeps the p7
    hit."""
    from mitoflex_tpu_torch.models import cmsearch

    model, rec, hit = _refine_inputs()

    def backend(model, window, anchor, slack, local=False):
        if error == "width limit":
            cyk_device.check_kernel_width(slack)
        raise ValueError("bifurcation band offset exceeds width")

    monkeypatch.setattr(cmsearch, "_banded_backend", lambda device=None: backend)
    if error == "width limit":
        with pytest.raises(cyk_device.KernelLimitError, match="band width 130"):
            cmsearch._cyk_banded_refine(model, rec, hit, slack=64, device="cpu")
    else:
        assert cmsearch._cyk_banded_refine(model, rec, hit, slack=12, device="cpu") is hit


def test_cpu_refine_takes_any_slack(monkeypatch):
    """On the CPU the tensor DP (the plain version) runs a band wider than
    the kernel's limit and rescores the hit, as before."""
    from mitoflex_tpu_torch.models import cmsearch

    model, rec, hit = _refine_inputs()
    monkeypatch.setenv("MITOFLEX_DEVICE_CYK", "1")
    got = cmsearch._cyk_banded_refine(model, rec, hit, slack=64, device="cpu")
    assert got is not hit and got.score > 10.0
    assert (got.seqfrom, got.seqto) == (hit.seqfrom, hit.seqto)


def test_step_table_is_the_jax_scan_table(jax_models):
    """The kernel's packed step table holds, row for row, what the JAX
    package's scan reads (its ``xs`` dict): state, kind, children and
    transitions, self-loop and local-end scores, the B state's children."""
    for key, local in (("trna", False), ("trna", True), ("rrna_180", True)):
        st = cyk_device._model_static(kernel_cases.cyk_model(key), local, torch.device("cpu"))
        table = cyk_device._step_table(st["steps"])
        f = table.view(np.float32)
        xs = jax_dev._model_static(jax_models[key], local)["xs"]
        xs = {k: np.asarray(v) for k, v in xs.items()}
        assert table.shape == (len(xs["v"]), cyk_device.STEP_WORDS)
        assert np.array_equal(table[:, cyk_device._W_V], xs["v"])
        is_b = table[:, cyk_device._W_KIND] < 0
        assert np.array_equal(is_b, xs["is_b"])
        assert np.array_equal(table[~is_b, cyk_device._W_KIND], xs["kind"][~is_b])
        assert np.array_equal(table[is_b, cyk_device._W_LEFT], xs["bl"][is_b])
        assert np.array_equal(table[is_b, cyk_device._W_RIGHT], xs["br"][is_b])
        kids = slice(cyk_device._W_KID, cyk_device._W_KID + cyk_device.MAX_KIDS)
        ts = slice(cyk_device._W_T, cyk_device._W_T + cyk_device.MAX_KIDS)
        n = table[~is_b, cyk_device._W_NKIDS]
        real = np.arange(cyk_device.MAX_KIDS)[None, :] < n[:, None]
        assert np.array_equal(np.where(real, table[~is_b, kids], 0), xs["kid"][~is_b])
        assert np.array_equal(np.where(real, f[~is_b, ts], np.float32(-1e30)),
                              xs["kid_t"][~is_b])
        has_self = (table[:, cyk_device._W_FLAGS] & cyk_device.HAS_SELF) != 0
        assert np.array_equal(has_self, xs["self_t"] > -5e29)
        assert np.array_equal(f[has_self, cyk_device._W_SELF], xs["self_t"][has_self])
        has_end = (table[:, cyk_device._W_FLAGS] & cyk_device.HAS_END) != 0
        assert has_end.any() == local
        assert np.array_equal(f[:, cyk_device._W_END], xs["end_sc"])


def test_kernel_source_is_in_the_library():
    assert "cyk.cu" in kernels.SOURCES
    with open(os.path.join(kernels.CSRC_DIR, "cyk.cu")) as f:
        src = f.read()
    assert re.search(r'extern "C" int mfx_cyk_banded\(const void\* steps, int n_scan, '
                     r'const void\* order,\s+const void\* e_states, int n_e, .*'
                     r'void\* deck, void\* out, void\* sync, int epoch,\s+void\* stream\)',
                     src, re.S)
    assert re.search(rf"constexpr int kMaxW = {cyk_device.KERNEL_MAX_W};", src)
    assert re.search(rf"constexpr int kStepWords = {cyk_device.STEP_WORDS};", src)
    assert re.search(rf"constexpr int kMaxKids = {cyk_device.MAX_KIDS};", src)
    offsets = dict(re.findall(r"(kW\w+) = (\d+)", src))
    assert {k: int(v) for k, v in offsets.items()} == {
        "kWV": cyk_device._W_V, "kWKind": cyk_device._W_KIND,
        "kWNKids": cyk_device._W_NKIDS, "kWLeft": cyk_device._W_LEFT,
        "kWRight": cyk_device._W_RIGHT, "kWKid": cyk_device._W_KID, "kWT": cyk_device._W_T,
        "kWSelf": cyk_device._W_SELF, "kWEnd": cyk_device._W_END,
        "kWFlags": cyk_device._W_FLAGS}
    assert "--use_fast_math" not in " ".join(kernels.compile_command("cyk.cu", "x.o"))
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    # an E state's kind is none of the step table's (-1 for B, 0 to 3)
    assert consts["kKindE"] not in range(-1, 4)
    # a thread's rows cover every band width the kernel takes, and a B
    # state's tiles its cells at the widest
    for W in range(2, cyk_device.KERNEL_MAX_W + 1):
        assert (consts["kThreads"] // W) * consts["kMaxRows"] >= W
    assert (consts["kMaxW"] // consts["kTile"]) ** 2 == consts["kThreads"]
    # shared memory (smem_bytes): as many whole child blocks as fit in the
    # opt-in limit beside the static shared memory and two W-vectors, up to
    # a state's most children; the golden width takes all of them at once,
    # the widest three, and the B operands fit in either
    optin, static = 232448, 1024
    for W, want in ((26, 6), (98, 6), (cyk_device.KERNEL_MAX_W, 3)):
        slots = min(cyk_device.MAX_KIDS, (optin - static - 8 * W) // (4 * W * W))
        P = (W + 3) // 4 * 4
        region = max(slots * W * W, 2 * P * P, W * W + consts["kThreads"])
        assert slots == want and (region + 2 * W) * 4 + static <= optin
    assert kernels._lib is None


def test_rrna_width_instantiation_is_the_refine_width():
    """The kernel's own instantiation for the rRNA refine (kRrnaW, every
    stride an immediate) is the band width at the refine's default slack, so
    a change of that default fails here rather than moving every rRNA call
    to the slower any-width instantiation."""
    with open(os.path.join(kernels.CSRC_DIR, "cyk.cu")) as f:
        src = f.read()
    slack = inspect.signature(cmsearch._cyk_banded_refine).parameters["slack"].default
    want = cyk_device.check_kernel_width(slack)
    assert re.search(rf"constexpr int kRrnaW = {want};", src)
    assert "const bool rrna = W == kRrnaW;" in src
    assert "rrna ? cyk_kernel<kRrnaRows, kRrnaW>" in src
