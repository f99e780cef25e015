"""Check and time the port's kernels (K1 read filter, K2 and K3 merges, K4
sort, C1 banded CYK, V1 and V2 Viterbi passes, S1 Smith-Waterman, G1
genewise) on one GPU.

    python3 scripts/torch_kernel_bench.py [--repo DIR] [--check] [--time]
                                          [--kernels K1,K2,K3,K4,C1,V1,V2,S1,G1]
                                          [--shapes FILE] [--viterbi-calls FILE]
                                          [--layouts] [--label NAME] [--out FILE]

``--repo DIR`` imports ``mitoflex_tpu_torch`` from another checkout (for
example the parent commit unpacked by ``git archive``), so that two versions
can be timed in turns within one run on one card; only the public wrappers
of ``ops/psort.py`` and ``ops/filter.py`` are called, which both versions
share (K1's raw launches go through ``launch_filter`` where the checkout
has it, and through the earlier C entry point with its precomputed cutoffs
and power tables where it has not).

``--check`` runs every case of ``mitoflex_tpu_torch.testing.kernel_cases``
through the kernels and holds the results against the plain versions
(exact; ``kernel_cases.check_wrappers``). ``--time`` prints one JSON line per shape: the kernel's median
milliseconds over CUDA-event-timed repeats after a warm-up (``ms``: one
wrapper call between two events, so it includes the wrapper's host time
before the launch), the time per call of 20 calls enqueued back to back
(``back_to_back_ms``), its bound (bytes
moved once at 3.35 TB/s) and, for the sort, ``torch.sort`` on the packed
key plus the gather. K1 is timed at 65536 x 256 and at the golden batch
(8192 reads x 160 columns), held bit-equal to ``filter_reads_ref`` first,
and also gets ``raw_ms``: the launcher called 20 times on preallocated
outputs between one pair of events, the device's own time a launch.
``--shapes FILE`` adds K2 shapes from a JSON list of
``[na, nb, W]`` (the runs a pipeline run really merged). C1 (only when
``--kernels`` names it) is timed at the golden run's shapes through the
public wrapper ``ops.cyk_device.cyk_banded_device``: seeded fixture rRNA
models of CLEN 950 and 1100 (``testing/cm_fixture.rrna_cm``), their
consensus inside 64 random bases on each side (windows of 1078 and 1228
nt), slack 48 (W 98), local mode; each call's median, min and max over
CYK_REPEATS calls, its bound (every W x W block written once, with the
inputs and outputs, at 3.35 TB/s) and, where the checkout has it, the
schedule's depth; with ``--check``, every case of
``kernel_cases.cyk_cases`` against the plain version on the CPU first. V1
(``viterbi_scores_multi``) and V2 (``viterbi_scan``), when ``--kernels``
names them, are timed through their public wrappers on seeded profiles
(``profile_from_consensus`` of random consensus sequences) and windows with
planted copies: the golden run's largest call of each pass (from
``--viterbi-calls``, the ``viterbi_golden_calls.json`` that ``chip_smoke.py``
phase 13 writes; without it, Lp 2048 models of length 1100 on 28 and 3
windows of 2200), the shapes of ``chip_smoke.py``'s VITERBI_SHAPES, and,
given the file, every golden call replayed and summed per pass (each call's
median of VITERBI_GOLDEN_REPEATS). Each row: median ms of VITERBI_REPEATS
calls, ns a step (ms over the longest row's steps), the operations bound at
67 TFLOP/s and, where the checkout has ``viterbi_config``, the layout; with
``--check``, ``kernel_cases.check_viterbi`` on the card first. S1
(``sw_align``) and G1 (``genewise_align``), when ``--kernels`` names them,
are timed through their public wrappers only (so ``--repo`` can run an
earlier tree's kernels) on seeded inputs (``dp_shapes``): S1's golden call
(48 pairs x Lq 100 x Lt 5163), the blastn size (2 x 16,500 x 300) and a
real-size tblastn call (64 x 600 x 5300, planted homologs); G1's golden
call (12 x 100 x 359) and real size (2 x 600 x 1950). Each row: median, min
and max of DP_REPEATS calls, ns a step over the call's longest chain (its
stage steps where the checkout has a layout chooser, else the first
design's strips one after another), the operations bound at 67 TFLOP/s,
and the checkout's layout; ``--layouts`` times each layout the chooser
weighs at the shape too; with ``--check``, ``kernel_cases.check_sw`` and
``check_genewise`` on the card first and every timed call bit-equal to
the plain version. The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s


def cuda_ms(fn, repeats: int = 20) -> float:
    return float(np.median(cuda_times(fn, repeats)))


def cuda_times(fn, repeats: int) -> list:
    """Milliseconds of each of ``repeats`` calls of fn(), each between two
    events, after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms_back_to_back(fn, calls: int = 20, repeats: int = 5) -> float:
    """Median milliseconds per call when ``calls`` calls are enqueued between
    one pair of events: the device's time per call once the host's enqueue
    cost overlaps it (for a kernel shorter than its wrapper's host time it
    is that host time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def random_run(psort, gen, n: int, W: int, dev):
    """A sorted run of n rows from a pool of n/4 keys, with an all-ones
    block."""
    pool = torch.randint(-2**31, 2**31, (W, max(n // 4, 1)), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    keys = pool[:, torch.randint(0, max(n // 4, 1), (n,), generator=gen, device=dev)]
    keys[:, : n // 64] = -1
    return keys[:, psort.lexsort_words(keys)].contiguous()


def _emitter(label: str, out_path):
    def emit(**row):
        row["label"] = label
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")
    return emit


def time_filter(dev, label: str, out_path=None) -> None:
    """K1 at 65536 x 256 and at the golden batch shape, 8192 x 160."""
    from mitoflex_tpu_torch import kernels
    from mitoflex_tpu_torch.ops import filter as F

    emit = _emitter(label, out_path)
    args = (10, 55, 0.2)
    for B, L in ((65536, 256), (8192, 160)):
        rng = np.random.default_rng(B + L)
        seqs = torch.from_numpy(rng.integers(0, 5, (B, L)).astype(np.int8)).to(dev)
        quals = torch.from_numpy(rng.integers(35, 74, (B, L)).astype(np.int8)).to(dev)
        lens = torch.from_numpy(rng.integers(1, L + 1, B).astype(np.int32)).to(dev)
        got = F.filter_reads(seqs, quals, lens, *args)
        want = F.filter_reads_ref(seqs, quals, lens, *args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K1 disagrees with filter_reads_ref at {B}x{L}")
        ms = cuda_ms(lambda: F.filter_reads(seqs, quals, lens, *args))
        b2b = cuda_ms_back_to_back(lambda: F.filter_reads(seqs, quals, lens, *args))
        keep = torch.empty(B, dtype=torch.bool, device=dev)
        hashes = torch.empty((2, B), dtype=torch.int32, device=dev)
        if hasattr(F, "launch_filter"):
            def raw():
                F.launch_filter(seqs, quals, lens, lens, *args, keep, hashes)
        else:
            cut = F.quality_cutoffs(lens, args[2])
            p1, p2 = F._device_powers(L, dev)
            fn = kernels.library().mfx_filter_reads

            def raw():
                kernels.launch(seqs.device, fn, seqs.data_ptr(), quals.data_ptr(),
                               lens.data_ptr(), cut.data_ptr(), p1.data_ptr(),
                               p2.data_ptr(), B, L, args[0], args[1],
                               keep.data_ptr(), hashes[0].data_ptr(),
                               hashes[1].data_ptr())
        raw_ms = cuda_ms_back_to_back(raw)
        # bases, qualities, lengths and cutoff lengths in; keep, h1, h2 out
        emit(kernel="K1", B=B, L=L, ms=ms, back_to_back_ms=b2b, raw_ms=raw_ms,
             bound_ms=B * (2 * L + 8 + 9) / HBM_BYTES_PER_MS)


def time_shapes(psort, dev, label: str, extra_k2, out_path=None,
                which=("K2", "K3", "K4")) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    emit = _emitter(label, out_path)

    k2 = [(1 << 21, 1 << 21, 2), (1 << 21, 1 << 21, 8), (1 << 25, 1 << 25, 2)]
    for na, nb, W in (k2 + [tuple(s) for s in extra_k2]) if "K2" in which else []:
        a, b = random_run(psort, gen, na, W, dev), random_run(psort, gen, nb, W, dev)
        va = torch.randint(0, 2**20, (na,), generator=gen, device=dev, dtype=torch.int32)
        vb = torch.randint(0, 2**20, (nb,), generator=gen, device=dev, dtype=torch.int32)
        ms = cuda_ms(lambda: psort.merge_sorted_runs(a, va, b, vb))
        b2b = cuda_ms_back_to_back(lambda: psort.merge_sorted_runs(a, va, b, vb))
        emit(kernel="K2", na=na, nb=nb, W=W, P=1, ms=ms, back_to_back_ms=b2b,
             bound_ms=2 * 4 * (W + 1) * (na + nb) / HBM_BYTES_PER_MS)
        del a, b, va, vb
        torch.cuda.empty_cache()
    k3 = [(1 << 21, 1 << 21, 2, 0), (1 << 21, 1 << 21, 2, 1), (1 << 21, 1 << 21, 2, 2),
          (93_553, 93_551, 4, 1), (30_183, 30_177, 8, 1), (2_000_003, 1_999_997, 8, 1)]
    for na, nb, W, P in k3 if "K3" in which else []:
        a, b = random_run(psort, gen, na, W, dev), random_run(psort, gen, nb, W, dev)
        pa = torch.randint(0, 2**20, (P, na), generator=gen, device=dev, dtype=torch.int32)
        pb = torch.randint(0, 2**20, (P, nb), generator=gen, device=dev, dtype=torch.int32)
        ms = cuda_ms(lambda: psort.merge_sorted_runs_onepass(a, pa, b, pb))
        b2b = cuda_ms_back_to_back(
            lambda: psort.merge_sorted_runs_onepass(a, pa, b, pb))
        emit(kernel="K3", na=na, nb=nb, W=W, P=P, ms=ms, back_to_back_ms=b2b,
             bound_ms=2 * 4 * (W + P) * (na + nb) / HBM_BYTES_PER_MS)
        del a, b, pa, pb
        torch.cuda.empty_cache()
    for n in (1 << 20, 8192 * 129, 16384 * 225, 1 << 24) if "K4" in which else ():
        words = torch.randint(-2**31, 2**31, (2, n), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        ms = cuda_ms(lambda: psort.sort_words2(words))
        lib_ms = cuda_ms(lambda: psort.sort_words2_ref(words))
        b2b = cuda_ms_back_to_back(lambda: psort.sort_words2(words))
        emit(kernel="K4", n=n, ms=ms, back_to_back_ms=b2b, library_ms=lib_ms,
             bound_ms=2 * 8 * n / HBM_BYTES_PER_MS)
        del words
        torch.cuda.empty_cache()


CYK_REPEATS = 9
CYK_SEED = 2029


def cyk_golden_calls():
    """(model, window codes, anchor) at the golden run's two banded-CYK
    shapes, from CYK_SEED."""
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.models import cm as cm_models
    from mitoflex_tpu_torch.testing import cm_fixture

    rng = np.random.default_rng(CYK_SEED)
    for clen in (950, 1100):
        fx = cm_fixture.rrna_cm(f"bench_{clen}", rng, clen)
        model = cm_models.parse_cm_text(io.StringIO(fx.text))[0]
        flanks = ["".join("ACGT"[int(i)] for i in rng.integers(0, 4, 64)) for _ in range(2)]
        window = np.asarray(encoding.encode(flanks[0] + fx.consensus + flanks[1]))
        yield model, window, (64, 64 + clen - 1, 0, clen - 1)


def check_cyk(dev) -> int:
    """Every ``kernel_cases.cyk_cases`` case through the kernel against the
    plain version on the CPU (coordinates and argmax cells exact, scores
    within ``check_cyk``'s tolerance); returns the number bit-equal."""
    from mitoflex_tpu_torch.ops import cyk_device as cd
    from mitoflex_tpu_torch.testing import kernel_cases

    bit = 0
    for c in kernel_cases.cyk_cases():
        model = kernel_cases.cyk_model(c.model_key)
        got = cd.cyk_banded_maxima(model, c.window, c.anchor, c.slack, c.local, dev)
        want = cd.cyk_banded_maxima_plain(model, c.window, c.anchor, c.slack, c.local, "cpu")
        kernel_cases.check_cyk(got, want, c.name)
        bit += bool(np.array_equal(got.m.view(np.int32), want.m.view(np.int32)))
    return bit


def time_cyk(dev, label: str, out_path=None) -> None:
    """C1 at the golden run's two shapes, one wrapper call between two
    events, CYK_REPEATS calls after a warm-up."""
    from mitoflex_tpu_torch.ops import cyk_device as cd

    emit = _emitter(label, out_path)
    for model, window, anchor in cyk_golden_calls():
        def call():
            return cd.cyk_banded_device(model, window, anchor, 48, True, dev)

        want = cd.cyk_banded_maxima_plain(model, window, anchor, 48, True, "cpu")
        got = cd.cyk_banded_maxima(model, window, anchor, 48, True, dev)
        bit = bool(np.array_equal(got.m.view(np.int32), want.m.view(np.int32))
                   and np.array_equal(got.a, want.a))
        times = cuda_times(call, CYK_REPEATS)
        x = cd.kernel_inputs(model, window, anchor, 48, True, dev)
        inputs = sum(t.numel() * t.element_size()
                     for t in (x.step_table, x.e_states, x.single5, x.pair5, x.geo))
        emit(kernel="C1", states=x.n_states, W=x.W, L=x.L, ms=float(np.median(times)),
             min_ms=min(times), max_ms=max(times),
             bound_ms=(4 * x.W * x.W * x.n_states + inputs + 8 * x.n_states)
             / HBM_BYTES_PER_MS, depth=getattr(x, "depth", None), bit_equal_to_cpu=bit)


VITERBI_REPEATS = 7
VITERBI_GOLDEN_REPEATS = 3
VITERBI_SEED = 2031
F32_OPS_PER_MS = 67e9  # H100 SXM float32 outside the tensor cores, 67 TFLOP/s
# operations a cell, as chip_smoke.py's VITERBI_OPS: (base, a closure round)
VITERBI_OPS = {"V1": (15, 1), "V2": (30, 4)}
# chip_smoke.py's VITERBI_SHAPES: (pass, models, model length, windows, width)
VITERBI_SHAPES = (("V1", 22, 72, 512, 4096), ("V1", 1, 950, 512, 4096),
                  ("V1", 1, 1100, 512, 4096), ("V2", 1, 1100, 64, 4096))
PASS_NAMES = {"viterbi_scores_multi": "V1", "viterbi_scan": "V2"}


def viterbi_call(dev, rng, kernel, model_lens, Lp, B, T, lengths, band=16):
    """A seeded call of pass ``kernel`` (V1 or V2): a function running it
    through the public wrapper, and its (rows' longest steps, cells)."""
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.models.hmm import profile_from_consensus
    from mitoflex_tpu_torch.ops import phmm
    from mitoflex_tpu_torch.testing import synth

    cons = [synth.random_genome(rng, max(int(L), 1)) for L in model_lens]
    profs = [phmm.stage_profile(profile_from_consensus(f"B{i}", c), pad_to=Lp, device=dev)
             for i, c in enumerate(cons)]
    seqs = rng.integers(0, 4, (B, T)).astype(np.int8)
    for b in range(0, B, 3):  # a planted copy in every third window
        c = encoding.encode(cons[b % len(cons)])[:T]
        at = int(rng.integers(0, max(1, T - len(c))))
        seqs[b, at: at + len(c)] = c[: T - at]
    s = torch.from_numpy(seqs).to(dev)
    lens = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    steps = np.clip(np.asarray(lengths, np.int64), 0, T)
    cells = int(steps.sum()) * sum(min(max(int(L), 0), Lp) for L in model_lens)
    if kernel == "V2":
        prof = profs[0]
        return (lambda: phmm.viterbi_scan(prof, s, lens, int(model_lens[0]), band)), \
            max(int(steps.max()), 1), cells
    stack = phmm.stack_profiles(profs)
    ml = [int(L) for L in model_lens]
    return (lambda: phmm.viterbi_scores_multi(stack, ml, s, lens, band)), \
        max(int(steps.max()), 1), cells


def _viterbi_layout(kernel, Lp, rows, band):
    from mitoflex_tpu_torch.ops import phmm

    if not hasattr(phmm, "viterbi_config"):
        return None
    scan = kernel == "V2"
    return list(phmm.viterbi_config(Lp, rows, phmm.closure_window(band, scores=not scan),
                                    scan, torch.cuda.get_device_properties(0)
                                    .multi_processor_count))


def time_viterbi(dev, label: str, which, calls_path=None, out_path=None) -> None:
    """V1 and V2 at the golden run's largest calls, at VITERBI_SHAPES and,
    given the golden calls, every call replayed and summed per pass."""
    from mitoflex_tpu_torch.ops import phmm

    emit = _emitter(label, out_path)
    rng = np.random.default_rng(VITERBI_SEED)
    recorded = []
    if calls_path:
        with open(calls_path) as f:
            recorded = [dict(c, kernel=PASS_NAMES[c["pass"]]) for c in json.load(f)]

    def size(c):
        return sum(min(L, c["Lp"]) for L in c["model_lens"]) * sum(
            min(max(x, 0), c["T"]) for x in c["lengths"])

    largest = {}
    for c in recorded:
        if c["kernel"] not in largest or size(c) > size(largest[c["kernel"]]):
            largest[c["kernel"]] = c
    for kernel, B in (("V1", 28), ("V2", 3)):
        largest.setdefault(kernel, {"kernel": kernel, "model_lens": [1100], "Lp": 2048,
                                    "B": B, "T": 2200, "band": 16, "lengths": [2200] * B})
    shapes = [dict(largest[k], what="golden largest") for k in ("V1", "V2") if k in which]
    shapes += [{"kernel": k, "model_lens": [L] * Mn, "Lp": None, "B": B, "T": T,
                "band": 16, "lengths": [T] * B, "what": "shape"}
               for k, Mn, L, B, T in VITERBI_SHAPES if k in which]

    def bound(kernel, cells, band):
        base, per_round = VITERBI_OPS[kernel]
        W = phmm.closure_window(band, scores=kernel == "V1")
        return cells * (base + per_round * (max(W, 1).bit_length() - 1)) / F32_OPS_PER_MS

    for c in shapes:
        Lp = c["Lp"] or max(128, 1 << (max(c["model_lens"]) - 1).bit_length())
        fn, steps, cells = viterbi_call(dev, rng, c["kernel"], c["model_lens"], Lp, c["B"],
                                        c["T"], c["lengths"], c["band"])
        ms = cuda_ms(fn, VITERBI_REPEATS)
        emit(kernel=c["kernel"], what=c["what"], models=len(c["model_lens"]),
             model_len=max(c["model_lens"]), Lp=Lp, B=c["B"], T=c["T"], ms=ms,
             ns_step=ms * 1e6 / steps, cells=cells, bound_ms=bound(c["kernel"], cells,
                                                                    c["band"]),
             layout=_viterbi_layout(c["kernel"], Lp, len(c["model_lens"]) * c["B"],
                                    c["band"]))
    for kernel in ("V1", "V2"):
        calls = [c for c in recorded if c["kernel"] == kernel]
        if kernel not in which or not calls:
            continue
        total = cells_all = bound_all = 0
        for c in calls:
            fn, _, cells = viterbi_call(dev, rng, kernel, c["model_lens"], c["Lp"], c["B"],
                                        c["T"], c["lengths"], c["band"])
            total += cuda_ms(fn, VITERBI_GOLDEN_REPEATS)
            cells_all += cells
            bound_all += bound(kernel, cells, c["band"])
        emit(kernel=kernel, what="golden replay", calls=len(calls), ms=total,
             cells=cells_all, bound_ms=bound_all)


DP_REPEATS = 7
DP_SEED = 2032
# operations a cell, as chip_smoke.py's SW_OPS_PER_CELL and
# GENEWISE_OPS_PER_CELL
DP_OPS = {"S1": 61, "G1": 81}
LANES = 32


def _planted_pairs(rng, B: int, Lq: int, Lt: int, K: int, fill: int):
    """[B, Lq] queries and [B, Lt] targets of random codes below K - 1; every
    target but each fourth holds a copy of its query with a substitution
    every 10 residues and 3 residues inserted in the middle."""
    q = rng.integers(0, K - 1, (B, Lq)).astype(np.int8)
    t = rng.integers(0, K - 1, (B, Lt)).astype(np.int8)
    for i in range(B):
        if i % 4 == 3:
            continue
        h = Lq // 2
        core = np.concatenate([q[i, :h], rng.integers(0, K - 1, 3), q[i, h:]]).astype(np.int8)
        core[::10] = rng.integers(0, K - 1, len(core[::10]))
        core = core[:Lt]
        at = int(rng.integers(0, Lt - len(core) + 1))
        t[i, at: at + len(core)] = core
    return q, np.full(B, Lq, np.int32), t, np.full(B, Lt, np.int32)


def _genes(rng, B: int, Lq: int, T: int, kinds):
    """[B, Lq] proteins and [B, T] translated windows (table 5): each window
    a random ORF of Lq codons, edited by its kind (clean, plus1 or minus1:
    a base gained or lost in the middle), in random flanks."""
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.ops import genewise

    gc = codon.get_code(5)
    sense = [c for c, a in sorted(gc.forward.items()) if a != "*"]
    qa = np.full((B, Lq), codon.X_CODE, np.int8)
    ta = np.full((B, T), 4, np.int8)
    for i in range(B):
        nt = "".join(sense[int(k)] for k in rng.integers(0, len(sense), Lq))
        qa[i] = codon.aa_encode(gc.translate_str(nt))
        mid = 3 * (Lq // 2)
        kind = kinds[i % len(kinds)]
        if kind == "plus1":
            nt = nt[:mid] + "A" + nt[mid:]
        elif kind == "minus1":
            nt = nt[:mid] + nt[mid + 1:]
        room = T - len(nt)
        left = int(rng.integers(0, room + 1))
        w = "".join("ACGT"[int(k)] for k in rng.integers(0, 4, T))
        w = w[:left] + nt + w[left + len(nt):]
        ta[i] = encoding.encode(w[:T])
    return qa, np.full(B, Lq, np.int32), genewise.translate_windows(ta, 5), \
        np.full(B, T, np.int32)


def dp_shapes(which):
    """(kernel, what, numpy arrays, gap costs) of the S1 and G1 shapes: the
    golden run's calls (S1 48 pairs x Lq 100 x Lt 5163, BLOSUM62 at 12/1;
    G1 12 hits x 100 aa x 359 nt), the blastn size (2 x a 16,500-base contig
    against 300-base windows, DNA at 7/2), a real-size tblastn call (64
    pairs x Lq 600 x Lt 5300) and G1's real size (2 x 600 aa x 1950 nt)."""
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.ops import sw

    rng = np.random.default_rng(DP_SEED)
    aa = codon.blosum62().astype(np.float32)
    nt = sw.nucleotide_matrix().astype(np.float32)
    if "S1" in which:
        yield "S1", "golden call", _planted_pairs(rng, 48, 100, 5163, codon.NUM_AA,
                                                  codon.X_CODE), aa, (12.0, 1.0)
        contig = rng.integers(0, 4, 16500).astype(np.int8)
        t = np.stack([contig[9000:9300].copy(), rng.integers(0, 4, 300).astype(np.int8)])
        t[0, 100:104] = (t[0, 100:104] + 1) % 4
        yield "S1", "blastn size", (np.stack([contig, contig]), np.full(2, 16500, np.int32),
                                    t, np.array([300, 297], np.int32)), nt, (7.0, 2.0)
        yield "S1", "real-size tblastn", _planted_pairs(rng, 64, 600, 5300, codon.NUM_AA,
                                                        codon.X_CODE), aa, (12.0, 1.0)
    if "G1" in which:
        pen = (13.0, 3.0, 15.0, 20.0)
        yield "G1", "golden call", _genes(rng, 12, 100, 359, ("clean", "plus1", "minus1")), \
            codon.blosum62().astype(np.float32), pen
        yield "G1", "real size", _genes(rng, 2, 600, 1950, ("plus1", "minus1")), \
            codon.blosum62().astype(np.float32), pen


def _dp_layouts(kernel, Lq, Lt, every: bool) -> list:
    """The checkout's layout for the shape (None where it has no chooser)
    and, with ``every``, each layout its chooser weighs at these widths."""
    from mitoflex_tpu_torch.ops import genewise, sw

    mod, name = (sw, "sw") if kernel == "S1" else (genewise, "genewise")
    if not hasattr(mod, f"{name}_config"):
        return [None]
    own = getattr(mod, f"{name}_config")(Lq, Lt)
    if not every:
        return [own]
    return [own] + [c for c in getattr(mod, f"{name}_configs")(Lq, Lt) if c != own]


def _chain_steps(layout, q_lens, t_lens) -> int:
    """Steps of the call's longest chain: with a layout, the longest pair's
    (``PipelineConfig.steps``); without (the first design), one warp's strips of
    128 columns one after another."""
    return max([1] + [layout.steps(ql, tl) if layout is not None
                      else -(-ql // 128) * (tl + LANES - 1)
                      for ql, tl in zip(q_lens.tolist(), t_lens.tolist())])


def time_dp(dev, label: str, which, every_layout: bool, check: bool, out_path=None) -> None:
    """S1 and G1 at ``dp_shapes`` through the public wrappers: the median,
    min and max of DP_REPEATS calls at the checkout's layout (and, with
    ``every_layout``, at each layout its chooser weighs), ns a step over
    the longest chain, the operations bound at 67 TFLOP/s; with ``check``,
    each call's fields bit-equal to the plain version's first."""
    from mitoflex_tpu_torch.ops import genewise, sw

    emit = _emitter(label, out_path)
    for kernel, what, arrays, sub, pen in dp_shapes(which):
        q, ql, t, tl = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays)
        fn, plain = (sw.sw_align, sw.sw_align_plain) if kernel == "S1" \
            else (genewise.genewise_align, genewise.genewise_align_plain)
        subt = torch.from_numpy(sub).to(dev)
        want = plain(q, ql, t, tl, subt, *pen) if check else None
        B, Lq = q.shape
        Lt = t.shape[1]
        cells = int((ql.to(torch.int64) * tl.to(torch.int64)).sum())
        for layout in _dp_layouts(kernel, Lq, Lt, every_layout):
            kw = {} if layout is None else {"_config": layout}
            if want is not None:
                got = fn(q, ql, t, tl, subt, *pen, **kw)
                for g, w in zip(got, want):
                    if not torch.equal(g.contiguous().view(torch.int32),
                                       w.contiguous().view(torch.int32)):
                        raise AssertionError(f"{kernel} {what} differs from the plain version "
                                             f"at layout {layout}")
            times = cuda_times(lambda: fn(q, ql, t, tl, subt, *pen, **kw), DP_REPEATS)
            ms = float(np.median(times))
            emit(kernel=kernel, what=what, shape=[B, Lq, Lt], ms=ms, min_ms=min(times),
                 max_ms=max(times), ns_step=ms * 1e6 / _chain_steps(layout, ql.cpu(), tl.cpu()),
                 cells=cells, bound_ms=cells * DP_OPS[kernel] / F32_OPS_PER_MS,
                 layout=None if layout is None else list(layout),
                 bit_equal=want is not None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--kernels", default="K1,K2,K3,K4",
                    help="comma-separated subset of K1,K2,K3,K4,C1,V1,V2,S1,G1 to check "
                         "and time")
    ap.add_argument("--layouts", action="store_true",
                    help="time S1 and G1 at every layout their choosers weigh too")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--viterbi-calls", default=None,
                    help="the golden run's Viterbi calls (chip_smoke.py phase 13's "
                         "viterbi_golden_calls.json) to replay")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None,
                    help="also append the timing rows to this JSON-lines file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from mitoflex_tpu_torch import kernels
    from mitoflex_tpu_torch.ops import psort

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    kernels.library()
    print(f"{args.label}: kernels built in {kernels.last_build_seconds:.2f} s from "
          f"{args.repo}", flush=True)
    dev = torch.device("cuda")
    which = tuple(args.kernels.split(","))
    if args.check and "C1" in which:
        print(f"check: C1 on every cyk_cases case, coordinates and argmax cells equal to "
              f"the CPU plain version, {check_cyk(dev)} bit-equal", flush=True)
    if args.check and set(which) & {"V1", "V2"}:
        from mitoflex_tpu_torch.testing import kernel_cases

        print(f"check: V1 and V2 bit-equal to the plain versions on the card: "
              f"{kernel_cases.check_viterbi(dev)} (case, band) pairs", flush=True)
    if args.check and "S1" in which:
        from mitoflex_tpu_torch.testing import kernel_cases

        print(f"check: S1 bit-equal to its plain version on the card: "
              f"{kernel_cases.check_sw(dev)} (cases, calls)", flush=True)
    if args.check and "G1" in which:
        from mitoflex_tpu_torch.testing import kernel_cases

        print(f"check: G1 bit-equal to its plain version on the card and the CPU: "
              f"{kernel_cases.check_genewise(dev)} (cases, calls)", flush=True)
    if args.check and set(which) & {"K1", "K2", "K3", "K4"}:
        from mitoflex_tpu_torch.testing import kernel_cases

        print(f"check: {kernel_cases.check_wrappers(dev)} cases equal to the plain "
              f"versions", flush=True)
        if hasattr(kernel_cases, "check_filter"):
            print(f"check: K1 bit-equal to filter_reads_ref on "
                  f"{kernel_cases.check_filter(dev)} cases (vector and scalar "
                  f"paths; SE and PE cutoffs)", flush=True)
    if args.time:
        extra = []
        if args.shapes:
            with open(args.shapes) as f:
                extra = json.load(f)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        if "K1" in which:
            time_filter(dev, args.label, args.out)
        time_shapes(psort, dev, args.label, extra, args.out, which)
        if "C1" in which:
            time_cyk(dev, args.label, args.out)
        if set(which) & {"V1", "V2"}:
            time_viterbi(dev, args.label, which, args.viterbi_calls, args.out)
        if set(which) & {"S1", "G1"}:
            time_dp(dev, args.label, which, args.layouts, args.check, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
