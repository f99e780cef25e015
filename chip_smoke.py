"""Smoke run of the PyTorch port (mitoflex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 2026] [--out DIR]

Phases, each printing its own lines; any failure exits non-zero:

1. torch / CUDA versions and the card; build the CUDA kernel library from
   mitoflex_tpu_torch/csrc and the native host library from
   mitoflex_tpu_torch/native (both timed), so that neither build lands in
   a timed stage.
2. K1, the read-filter kernel, against its plain PyTorch version on the
   seeded cases of mitoflex_tpu_torch/testing/kernel_cases.py (its vector
   path, and its scalar path through row widths that are no multiple of 16
   and rows that are not 16-byte aligned; SE and PE cutoffs, odd codes and
   valves) and at 65536 x 256 (random reads plus edge rows): bit-equal.
   One call is one launch and never calls ``quality_cutoffs``. Timed at
   65536 x 256 and at the golden batch (8192 x 160): one wrapper call, and
   the device's own time from 20 raw launches on preallocated outputs
   between one pair of events; the plain version timed too.
3. K2, the sorted-run merge kernel, against its plain version at 2 x 2**21
   rows (W = 2 and W = 8 key words) and 2 x 2**25 rows (W = 2, the device
   LSM's cap): output sorted, keys exact, per-key payload sums equal; both
   timed. Then K2, K3 and K4 on the seeded cases of
   mitoflex_tpu_torch/testing/kernel_cases.py (run lengths around the tile
   sizes, an empty run, rows of 16 key and 4 payload words, deep ties, more
   than a tile of one key, sort lengths that are no multiple of the tile):
   equal to the plain versions.
4. K3, the one-pass merge kernel, against its plain version at 2 x 2**21
   rows (W = 2; P = 0, 1, 2 payload words), 2 x 2**25 rows (W = 2,
   P = 1), and at the graph pass's shapes: W = 4 and 8, one payload word
   (row positions), ragged run lengths near the golden edge counts, a run
   with a long tie block.
   Row-for-row equal (both put run A's rows first on ties); both timed.
5. K4, the 2-word key sort, against its plain version on keys with
   duplicates and an all-ones block at 2**20 keys, at the golden chunk
   (8192 reads x 129 windows = 1,056,768 keys), at the default chunk
   (16384 reads x 225 windows = 3,686,400 keys) and at 2**24 keys: equal;
   both timed.
6. The whole pipeline, filter -> assemble -> findmitoscaf -> annotate ->
   visualize, at the golden-sample volume through ``run_all``: the
   synthetic profile set's genome
   (mitoflex_tpu_torch/testing/profile_fixture.py, spacer 2440,
   link_rna=True: a ~15.6 kb circle with four PCGs, four tRNAs and two
   rRNAs whose covariance models, CLEN 72, 950 and 1100, the CM fixture
   writes) at 400x plus two 8 kb nuclear decoys at 12x, 150 bp pairs,
   insert 300, 1% errors, from --seed, through the port's
   PipelineContext(device="cuda") and ``run_all``. All nine kernels'
   launch counters (K1 to K4, the two Viterbi passes, Smith-Waterman, the
   banded CYK and genewise) are zeroed just before and read just after;
   each must be > 0, and the plain Viterbi, SW, CYK and genewise loops must
   see no card. Every Viterbi call's inputs are kept for phase 13, every SW
   call's for phase 14, every banded CYK call's for phase 15 and every
   genewise call's for phase 16 (its wall and launches a call printed),
   and every ``nhmmer_search``
   call is timed by the stage that made it: under annotate this splits the
   tRNA and rRNA walls into the p7 filter scan and the CYK refinement (the
   banded CYK calls timed apart). The SW calls and blast's ``_batched_sw``
   are timed too, which splits annotate's tblastn wall into the SW batches
   and the host work around them.
   The summary must hold ``picked``, ``locs``, ``circular`` (true) and
   ``plots``; ``depth_mean`` of ``mt1`` in ``tracks.json`` must lie between
   0.7 and 1.05 times the planted 400x, ``depth.txt`` must have one row per
   base of the picked scaffold, and every gene of ``locs.json`` its row in
   ``gene.txt``. Where matplotlib cannot be imported the script says so, runs
   ``all`` with ``disable_visualization`` and calls the stage's
   ``build_tracks`` itself (no figure). The picked
   FASTA must hold a circular scaffold equal to the planted genome up to
   rotation and strand once its (k-1)-base terminal duplication is
   dropped, and the manifest must list all four PCGs as found. annotate's
   ``locs.json`` must list the four PCGs, the planted tRNAs under
   ``trn<letter>`` and ``rrnS`` / ``rrnL``, each on its planted strand,
   and each annotated fragment must be the planted sequence within 2
   codons at either end (which places it up to the circle's rotation);
   the walls of all five stages and their parts are printed.
7. K2 again on the runs that the golden run's k-mer LSM really merged
   (recorded during phase 6): keys exact, per-key payload sums equal; each
   shape timed. K3 again on the edge tables that the golden run's graph
   passes took (one per pass, k = 31 to 119, W = 2 to 8): row-for-row equal
   to its plain version and timed alone; the node step (node table and
   endpoint ids) and the whole graph pass timed with K3 and with the
   sort-and-join formulation that K3 replaced.
8. A small read set through the whole pipeline twice, as the subprocesses
   ``python3 -m mitoflex_tpu_torch all`` with no ``--device`` (the card)
   and with ``--device cpu`` (the host formulations, held against the JAX
   package by tests/test_torch_pipeline.py), started together: exit 0 both
   times; the planted circle picked and annotated; the clean FASTQs, the
   contigs, the picked FASTA, ``locs.json``, both annotated FASTAs,
   ``wise.csv`` and the seven text track files byte-identical,
   ``circos.conf`` once each run's directory is replaced.
9. ``genewise_align`` (the kernel of phase 16) on the card against the
   CPU on a seeded batch (frameshifts, stops, a window that holds its gene
   twice): coordinates and frameshift counts equal, scores within 1e-4;
   timed (host clock around a call that ends in a synchronise) with its
   kernel launches counted. The banded CYK, which this phase
   held until its kernel came, is phase 15's.
10. The rest of the command line on phase 8's card run: ``visualize``
   alone on the picked FASTA with ``--locs`` (the same track files again;
   without matplotlib it must exit 2 naming it and write nothing),
   ``python3 -m mitoflex_tpu_torch.check_circular`` on the picked FASTA (the
   planted circle must be called circular), and ``all --resume`` without
   ``--keep-temp``: exit 0, ``resume: skipping`` logged for cleandata,
   assemble and findmitoscaf, the stage directories gone, the results there.
11. ``run_bim`` on the same reads, two generations (``iteration_ignore``
   0), on the card in this process and on the CPU through ``bim --device
   cpu`` (started beside phase 10's resume run): picked FASTA byte-identical; its longest record is the planted
   genome (a substring of the doubled genome, at most 50 bases short);
   K1 to K4 launched; the bait mapping's reads/s printed (generation 0's
   mapping repeated alone, its kept pairs equal to the run's).
12. The device mesh (mitoflex_tpu_torch/parallel/mesh.py), in four parts:
   right after phase 7, ``run_filter`` and ``run_assemble`` on phase 6's
   reads with a mesh of 4 shards of the one card
   (``make_mesh(devices=[cuda] * 4)``: sharded filter, ShardedKmerCounter,
   sharded graph pass): clean FASTQs, ``contigs.fa`` and the scaffolds
   byte-identical to phase 6's, K1 to K4 launched (counters zeroed just
   before, read just after); right after phase 8, ``run_findmitoscaf`` and
   ``run_annotate`` of phase 8's card contigs over 2 shards: picked FASTA
   and ``locs.json`` byte-identical to phase 8's card run; each sharded
   function alone on 4 shards against its single-device call on seeded
   inputs (filter, partitioned counting with keys whose first word is at
   least 2**31 and each shard inside its key range, mapper, SW, genewise,
   both Viterbi passes: coordinates equal, scores within 1e-4; both Viterbi
   kernels, the SW and the genewise kernel launched, and on the small set's
   sharded findmitoscaf and annotate too, with the CYK kernel); and
   ``init_distributed`` with NCCL at world size 1 through a file://
   rendezvous, one all_reduce, torn down. Mesh walls are printed beside
   the single-device walls of this run.
13. The two Viterbi passes of mitoflex_tpu_torch/csrc/viterbi.cu (run
   right after phase 7) against their plain loops: on every seeded case of
   ``kernel_cases.viterbi_cases`` at delete bands 16, 10 and 0 and at every
   layout ``ops.phmm.viterbi_config`` can pick for the case's width (a
   private ``_config`` keyword of the wrappers forces each; scores
   bit-equal, every coordinate exact), the chooser's shared-memory formula
   against the library's; at the golden run's largest call of each pass,
   and at the shapes of the golden run's largest searches (22 tRNA-size
   models at Lp 128, the rRNA sizes at Lp 1024 and 2048, 512 windows of
   4096; the envelope scan at Lp 2048 on 64 windows of 4096), each timed
   beside its plain loop and its bound (the float32 operations that the
   call's cells need at 67 TFLOP/s, or its bytes once at 3.35 TB/s where
   that is larger) with its layout and ns a step (ms over the longest
   row's steps); every golden call replayed, one line each (shape, layout,
   ms, ns a step), its shape written to ``viterbi_golden_calls.json`` in
   the run's directory; then findmitoscaf's ``nhmmer_search`` call of
   phase 6 again, alone, with its kernel launches counted under
   torch.profiler.
14. The Smith-Waterman kernel of mitoflex_tpu_torch/csrc/sw.cu (run right
   after phase 13) against its plain loop on the same card tensors, all
   nine fields bit-equal: on every seeded case of ``kernel_cases.sw_cases``
   (BLOSUM62 and DNA gap costs, query lengths around the kernel's lanes and
   strips, empty, all-N/X and odd-code rows, tied best cells, a query whose
   best alignment starts past column 2^15, a 16,500-column contig against
   300-base windows, and a 65,600-column query over the packed path fields'
   limit) at every layout ``ops.sw.sw_config`` weighs for the case's
   widths (columns a lane, warps a pair, cluster, wide fields, target
   positions a lane a step; one layout an instantiation, the pick among
   them), the wide instantiation and a wrapping layout (a private
   ``_config`` keyword forces each), the chooser's shared-memory formula
   against the library's; each case, a real-size tblastn call (64 pairs x
   Lq 600 x Lt 5300, seeded, planted homologs) and the golden run's largest
   SW call timed beside the plain loop and its bound (the operations its
   cells need at 67 TFLOP/s, or its bytes once at 3.35 TB/s where that is
   larger) with its layout and ns a step (ms over the longest chain's
   stage steps); one wrapper call of the golden call must make exactly one
   kernel launch; then every SW call of the golden run through the kernel
   again, timed.
15. The banded CYK kernel of mitoflex_tpu_torch/csrc/cyk.cu (run right
   after phase 14) on every seeded case of ``kernel_cases.cyk_cases`` (the
   tRNA-size model at slack 8, 12 and 48, CLEN 180 and 950, glocal and
   local; planted, mutated, twice-planted, N-holding, truncated, all-N,
   junk windows and one shorter than the band) and on the golden run's
   calls: held against the plain loop on the CPU (coordinates, origins and
   argmax cells exact, scores within 1e-3 bits, or 4 float32 ulps where a
   parse scores below -3e4; whether the maxima are bit-equal is printed)
   and on the same card (maxima and picks; its prefix sums take CUDA's
   order, so its raw argmax cells may differ on near ties); host banded <=
   kernel <= exact CYK at the tRNA size; each golden call and a case of
   each model timed beside the plain loop on the card and the bound (every
   block written and every child block read once at 3.35 TB/s, or the
   float32 operations at 67 TFLOP/s where that is larger); the golden
   models' schedule depth (the states on their longest chain of children,
   which the kernel's dataflow walks); a tRNA-size call must make exactly
   one kernel launch.
16. The genewise kernel of mitoflex_tpu_torch/csrc/genewise.cu (run right
   after phase 15) on every seeded case of ``kernel_cases.genewise_cases``
   (frameshifts of every step, stops, N codons, both penalty sets, a gene
   planted twice, lengths 0 to 2, odd codes, 1 to 3 strips, a 600-aa
   protein in a 2000-base window, a query whose best alignment starts past
   residue 2^15, a 65,600-residue query over the packing limit) at every
   layout ``ops.genewise.genewise_config`` weighs, the wide instantiation
   and a wrapping layout, and on the golden run's calls: all six fields
   bit-equal to the plain loop on the same card tensors and on the CPU;
   the real-size case and each golden call timed (median and spread of at
   least 5 calls, layout, ns a step) beside the plain loop on the card and
   the operations bound; one wrapper call of each golden call must make
   exactly one kernel launch.

Kernel times are medians of CUDA-event-timed repeats after a warm-up; one
repeat is one call of the kernel's wrapper between two events, so it holds
the wrapper's host time before the launch too. Phases 13 to 16 also replay
every call the golden run made of the Viterbi passes, Smith-Waterman, the
banded CYK and genewise, each timed so, and sum them (``golden_sum_ms``
in the per-kernel line, beside ``golden_launches``, the kernel's launches in
phase 6's golden run, the same count as ``launches``). Kernel launches are counted under torch.profiler over every launch
call of the CUDA runtime API and of the lower-level cu* API
(``LAUNCH_APIS``). K1 to K4's bound is the
bytes of their inputs and outputs, moved once at the H100's 3.35 TB/s; the
Viterbi, SW and genewise kernels' is their operations (phases 13, 14 and
16), the CYK kernel's its blocks' bytes (phase 15). The last two lines are one JSON object of per-kernel results and then
{"ok": true, "device": {...}}; the card's name and power limit (from
nvidia-smi) are printed before them. Without a CUDA device the script exits
non-zero before any result.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
REPEATS = 20


def _log(msg: str) -> None:
    print(msg, flush=True)


def _nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of fn() on the current stream, after warm-up."""
    return float(np.median(_cuda_times(fn, repeats)))


def _cuda_times(fn, repeats: int = REPEATS) -> list:
    """Milliseconds of each of ``repeats`` calls of fn() on the current
    stream, each between two events, after warm-up."""
    for _ in range(2):
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


HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s


def _bound_ms(*tensors) -> float:
    """Least milliseconds the card could take to read the inputs and write
    the outputs given (every byte moved once at the device-memory rate)."""
    return sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_MS


# ------------------------------------------------------------------ K1
def _cuda_ms_back_to_back(fn, calls: int = 20, repeats: int = 5) -> float:
    """Median milliseconds per call of ``calls`` calls enqueued between one
    pair of events: the device's own time where the host enqueues faster."""
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


def _time_filter(F, t, args) -> dict:
    """Wrapper, raw-launch and plain times and the bound at one shape."""
    B = t[0].shape[0]
    keep = torch.empty(B, dtype=torch.bool, device=t[0].device)
    hashes = torch.empty((2, B), dtype=torch.int32, device=t[0].device)
    got = F.filter_reads(*t[:3], *args)
    return {
        "ms": _cuda_ms(lambda: F.filter_reads(*t[:3], *args)),
        "raw_ms": _cuda_ms_back_to_back(
            lambda: F.launch_filter(*t[:3], t[2], *args, keep, hashes)),
        "plain_ms": _cuda_ms(lambda: F.filter_reads_ref(*t[:3], *args)),
        # bases, qualities, lengths and the int32 cutoff lengths in; keep,
        # h1, h2 out
        "bound_ms": _bound_ms(*t[:3], t[2], *got),
    }


def check_filter(dev) -> dict:
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.ops import filter as F
    from mitoflex_tpu_torch.testing import kernel_cases

    n_cases = kernel_cases.check_filter(dev)
    torch.cuda.synchronize()
    B, L = 65536, 256
    rng = np.random.default_rng(1)
    seqs = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    quals = rng.integers(35, 74, size=(B, L)).astype(np.int8)
    lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    edge = [("ACGT" * 10, "I" * 40), ("N" * 11 + "A" * 29, "I" * 40),
            ("N" * 10 + "A" * 30, "I" * 40), ("ACGT" * 10, "#" * 40),
            ("ACGT" * 10, "#" * 7 + "I" * 33), ("ACGT" * 10, "#" * 8 + "I" * 32),
            ("A" * L, "I" * L)]
    for i, (s, q) in enumerate(edge):
        seqs[i] = encoding.N
        seqs[i, : len(s)] = encoding.encode(s)
        quals[i] = 0
        quals[i, : len(q)] = np.frombuffer(q.encode(), np.uint8)
        lengths[i] = len(s)
    lengths[-5:] = 0
    mate = rng.permutation(lengths).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (seqs, quals, lengths, mate)]
    args = (10, 55, 0.2)
    err = 0
    for cl in (None, t[3]):
        want = F.filter_reads_ref(*t[:3], *args, cl)
        # rows as they are (the vector path) and one byte off 16-byte
        # alignment (the scalar path)
        off = [torch.empty(B * L + 1, dtype=torch.int8, device=dev)[1:].view(B, L)
               .copy_(x) for x in t[:2]]
        for rows in (t[:2], off):
            got = F.filter_reads(*rows, t[2], *args, cl)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    keep = F.filter_reads(*t[:3], *args)[0][:6].tolist()
    if err != 0 or keep != [True, False, True, False, True, False]:
        raise AssertionError(f"K1 disagrees with filter_reads_ref: max err {err}, "
                             f"edge rows {keep}")
    # one call on the card is one launch, and the cutoff is the kernel's own
    real_cutoffs, before = F.quality_cutoffs, F.filter_reads.launches

    def no_cutoffs(*a, **k):
        raise AssertionError("filter_reads called quality_cutoffs on the CUDA path")

    F.quality_cutoffs = no_cutoffs
    try:
        F.filter_reads(*t[:3], *args, t[3])
    finally:
        F.quality_cutoffs = real_cutoffs
    if F.filter_reads.launches != before + 1:
        raise AssertionError("one filter_reads call must be one launch")
    r = _time_filter(F, t, args)
    gB, gL = 8192, 160   # the golden run's read_chunk x max_read_len
    g = [torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, 5, size=(gB, gL)).astype(np.int8),
        rng.integers(35, 74, size=(gB, gL)).astype(np.int8),
        rng.integers(1, gL + 1, size=gB).astype(np.int32))]
    if not all(torch.equal(a, b) for a, b in zip(
            F.filter_reads(*g, *args), F.filter_reads_ref(*g, *args))):
        raise AssertionError(f"K1 disagrees with filter_reads_ref at {gB}x{gL}")
    golden = _time_filter(F, g, args)
    _log(f"K1 filter_reads: bit-equal to filter_reads_ref on {n_cases} seeded cases "
         f"(vector and scalar paths, SE and PE cutoffs) and at {B}x{L} with the edge "
         f"rows on both paths; one launch a call, no quality_cutoffs")
    for shape, x in ((f"{B}x{L}", r), (f"{gB}x{gL}", golden)):
        _log(f"K1 filter_reads {shape}: wrapper call {x['ms']:.4f} ms, raw launch "
             f"{x['raw_ms']:.4f} ms, plain {x['plain_ms']:.4f} ms, bound "
             f"{x['bound_ms']:.4f} ms ({x['bound_ms'] / x['raw_ms']:.0%} of the "
             f"bound raw, {x['bound_ms'] / x['ms']:.0%} a wrapper call)")
    return {"max_abs_err": float(err), **r, "bound_by": "bytes", "library_ms": None,
            "golden_ms": golden["ms"], "golden_raw_ms": golden["raw_ms"],
            "golden_plain_ms": golden["plain_ms"],
            "golden_bound_ms": golden["bound_ms"]}


# ------------------------------------------------------------------ K2
def _random_run(gen, n: int, W: int, dev):
    """A sorted run of n rows drawn from a pool of n/4 random keys (so equal
    keys recur), with a block of all-ones rows (count-0 padding and a real
    all-T key) and random payloads."""
    from mitoflex_tpu_torch.ops import psort

    pool = torch.randint(-2**31, 2**31, (W, n // 4), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    pick = torch.randint(0, n // 4, (n,), generator=gen, device=dev)
    keys = pool[:, pick]
    keys[:, : n // 64] = -1
    vals = torch.randint(0, 2**20, (n,), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    vals[1 : n // 64] = 0
    perm = psort.lexsort_words(keys)
    return keys[:, perm].contiguous(), vals[perm].contiguous()


def _per_key_sums(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    new = torch.ones(keys.shape[1], dtype=torch.bool, device=keys.device)
    new[1:] = (keys[:, 1:] != keys[:, :-1]).any(0)
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    out = torch.zeros(int(new.sum()), dtype=torch.int64, device=keys.device)
    return out.index_add_(0, seg, vals.to(torch.int64) & 0xFFFFFFFF)


def _is_sorted(words: torch.Tensor) -> bool:
    """Whether the columns of words [W, n] are in unsigned lexicographic
    order."""
    from mitoflex_tpu_torch.ops import psort

    gt = torch.zeros(words.shape[1] - 1, dtype=torch.bool, device=words.device)
    eq = torch.ones_like(gt)
    for w in words:
        x, y = w[:-1] ^ psort._SIGN, w[1:] ^ psort._SIGN
        gt |= eq & (x > y)
        eq &= x == y
    return not bool(gt.any())


def _k2_compare_and_time(a, b, what: str) -> dict:
    """K2 against its plain version on the runs a = (keys, vals) and b:
    raises unless the output is sorted, its keys exact and its per-key
    payload sums equal; returns the error (0), both times and the bound."""
    from mitoflex_tpu_torch.ops import psort

    got = psort.merge_sorted_runs(*a, *b)
    want = psort.merge_sorted_runs_ref(*a, *b)
    torch.cuda.synchronize()
    if not _is_sorted(got[0]):
        raise AssertionError(f"K2 output not sorted ({what})")
    key_err = int((got[0].to(torch.int64) - want[0].to(torch.int64)).abs().max())
    sum_err = int((_per_key_sums(*got) - _per_key_sums(*want)).abs().max())
    if key_err or sum_err:
        raise AssertionError(f"K2 disagrees with merge_sorted_runs_ref ({what}): "
                             f"key err {key_err}, per-key sum err {sum_err}")
    bound_ms = _bound_ms(*a, *b, *got)
    del got, want
    ms = _cuda_ms(lambda: psort.merge_sorted_runs(*a, *b), repeats=10)
    plain_ms = _cuda_ms(lambda: psort.merge_sorted_runs_ref(*a, *b), repeats=10)
    return {"max_abs_err": float(max(key_err, sum_err)), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms}


def check_merge(dev) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    results = []
    for log2m, W in ((21, 2), (21, 8), (25, 2)):
        m = 1 << log2m
        a = _random_run(gen, m, W, dev)
        b = _random_run(gen, m, W, dev)
        r = _k2_compare_and_time(a, b, f"m=2^{log2m}, W={W}")
        _log(f"K2 merge_sorted_runs 2x2^{log2m} rows, W={W}: sorted, keys exact, "
             f"per-key sums equal; kernel {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
             f"{2 * m / r['ms'] / 1e6:.2f} Grows/s")
        results.append(r)
        del a, b
        torch.cuda.empty_cache()
    return results


def check_merge_golden(recorded) -> list:
    """K2 on the runs the golden run's k-mer LSM merged (``recorded``:
    (a_keys, a_vals, b_keys, b_vals) per launch, in launch order)."""
    results = []
    for i, (ak, av, bk, bv) in enumerate(recorded):
        W, na, nb = ak.shape[0], ak.shape[1], bk.shape[1]
        r = _k2_compare_and_time((ak, av), (bk, bv),
                                 f"golden LSM merge {i}: W={W}, {na} + {nb} rows")
        r.update(W=W, na=na, nb=nb)
        results.append(r)
    _log("K2 on the golden run's LSM merges (W, rows A + rows B: kernel / plain / "
         "bound ms), all sorted, keys exact, per-key sums equal: " + "; ".join(
             f"W={r['W']} {r['na']}+{r['nb']}: {r['ms']:.4f} / {r['plain_ms']:.4f} / "
             f"{r['bound_ms']:.4f}" for r in results))
    _log(f"K2 golden LSM merges: {len(results)} launches, kernel "
         f"{sum(r['ms'] for r in results):.4f} ms in all, bound "
         f"{sum(r['bound_ms'] for r in results):.4f} ms")
    return results


def check_kernel_cases(dev) -> int:
    """K2, K3 and K4 on the seeded cases of testing/kernel_cases.py, and the
    tile sizes that module's shapes are built around against the built
    library's. Raises on any difference from the plain versions; returns
    the number of cases."""
    from mitoflex_tpu_torch import kernels
    from mitoflex_tpu_torch.ops import psort
    from mitoflex_tpu_torch.testing import kernel_cases

    lib = kernels.library()
    if lib.mfx_sort_tile_rows() != psort.SORT_TILE_KEYS:
        raise AssertionError("psort.SORT_TILE_KEYS differs from the library's tile")
    for W, P in ((1, 0), (2, 1), (4, 1), (8, 1), (16, 4)):
        if lib.mfx_merge_tile_rows(W, P) != psort.merge_tile_rows(W, P):
            raise AssertionError(f"psort.merge_tile_rows({W}, {P}) differs from "
                                 f"the library's")

    n_cases = kernel_cases.check_wrappers(dev)
    torch.cuda.synchronize()
    _log(f"K2/K3/K4 on {n_cases} seeded edge cases (tile - 1, tile, tile + 1, empty "
         f"runs, W up to 16, P up to 4, deep ties, a tile of one key): equal to the "
         f"plain versions")
    return n_cases


# ------------------------------------------------------------------ K3
def _k3_compare(runs, what: str) -> int:
    """K3 against its plain version on runs = (a_keys, a_pays, b_keys,
    b_pays): raises unless row-for-row equal; returns the max error (0)."""
    from mitoflex_tpu_torch.ops import psort

    got = psort.merge_sorted_runs_onepass(*runs)
    want = psort.merge_sorted_runs_onepass_ref(*runs)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    if err:
        raise AssertionError(f"K3 disagrees with merge_sorted_runs_onepass_ref "
                             f"({what}): max err {err}")
    return err


def _k3_compare_and_time(runs, what: str) -> dict:
    """_k3_compare, then both versions timed and the bound of these runs
    (every input and output word moved once)."""
    from mitoflex_tpu_torch.ops import psort

    err = _k3_compare(runs, what)
    ms = _cuda_ms(lambda: psort.merge_sorted_runs_onepass(*runs), repeats=10)
    plain_ms = _cuda_ms(lambda: psort.merge_sorted_runs_onepass_ref(*runs), repeats=10)
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 2 * _bound_ms(*runs)}


def _prefix_like_run(gen, n: int, W: int, dev):
    """A sorted run of n rows shaped like the graph pass's prefix run: keys
    recur (a pool of n/4), one key fills a block of n/8 rows, and an
    all-ones block closes it."""
    from mitoflex_tpu_torch.ops import psort

    keys, _ = _random_run(gen, n, W, dev)
    keys[:, n // 3: n // 3 + n // 8] = keys[:, n // 3: n // 3 + 1]
    return keys[:, psort.lexsort_words(keys)].contiguous()


def _positions_runs(a, b, perm):
    """K3's inputs in the graph pass's node step: the sorted run a with its
    positions, and b sorted by perm with its positions after a's."""
    na = a.shape[1]
    pos_a = torch.arange(na, dtype=torch.int32, device=a.device)[None]
    return [a.contiguous(), pos_a, b[:, perm].contiguous(),
            (perm.to(torch.int32) + na)[None]]


def check_merge_onepass(dev) -> list:
    from mitoflex_tpu_torch.ops import psort

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    results = []
    for log2m, P in ((21, 0), (21, 1), (21, 2), (25, 1)):
        m = 1 << log2m
        runs = []
        for _ in range(2):
            keys, _vals = _random_run(gen, m, 2, dev)
            pays = torch.randint(-2**31, 2**31, (P, m), generator=gen, device=dev,
                                 dtype=torch.int64).to(torch.int32)
            runs += [keys, pays]
        r = _k3_compare_and_time(runs, f"m=2^{log2m}, P={P}")
        _log(f"K3 merge_sorted_runs_onepass 2x2^{log2m} rows, W=2, P={P}: row-for-row "
             f"equal; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
             f"{r['bound_ms']:.4f} ms, {2 * m / r['ms'] / 1e6:.2f} Grows/s")
        results.append(r)
        del runs
        torch.cuda.empty_cache()
    # the graph pass's shapes: row positions as the one payload word,
    # ragged lengths near the golden edge counts, a prefix-like run A (long
    # tie blocks) against a run B that shares half its keys
    for W, na, nb in ((4, 93_553, 93_551), (8, 30_183, 30_177), (8, 2_000_003, 1_999_997)):
        a = _prefix_like_run(gen, na, W, dev)
        fresh, _ = _random_run(gen, nb - nb // 2, W, dev)
        b = torch.cat([a[:, torch.randint(0, na, (nb // 2,), generator=gen,
                                          device=dev)], fresh], dim=1)
        perm = psort.lexsort_words(b)
        runs = _positions_runs(a, b, perm)
        r = _k3_compare_and_time(runs, f"W={W}, P=1, {na} + {nb} rows")
        _log(f"K3 merge_sorted_runs_onepass {na}+{nb} rows, W={W}, P=1 (prefix-like "
             f"run A with a {na // 8}-row tie block): row-for-row equal; kernel "
             f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
             f"{r['bound_ms']:.4f} ms")
        results.append(r)
        del runs, a, b
        torch.cuda.empty_cache()
    return results


def check_graph_pass_k3(passes) -> list:
    """K3 on the node-step inputs of the graph passes a slice ran
    (``passes``: (edge_words, edge_counts, k) each): row-for-row equal to
    its plain version; the node step and the whole pass timed with K3 and
    with the formulation it replaced (one sort of both runs for the node
    table, then a sort-based join for the endpoint ids)."""
    from mitoflex_tpu_torch.ops import dbg, kmer, psort

    def sort_and_join(a, b):
        cat = torch.cat([a, b], dim=1)
        u, n = kmer.unique_words_device(cat)
        ids = kmer.multiword_join_sorted(u, cat)
        return u, n, ids[: a.shape[1]], ids[a.shape[1]:]

    results = []
    for edges, counts, k in passes:
        W, E = edges.shape
        prefix, suffix = dbg.edge_prefix_suffix(edges, k)
        if not _is_sorted(prefix):
            raise AssertionError(f"graph pass k={k}: edge prefixes not sorted")
        k3 = _k3_compare_and_time(
            _positions_runs(prefix, suffix, psort.lexsort_words(suffix)),
            f"graph pass k={k}, W={W}, E={E}")
        got, want = kmer.union_ranks(prefix, suffix), sort_and_join(prefix, suffix)
        if got[1] != want[1] or not all(torch.equal(g, w) for g, w in
                                        zip(got[::2] + got[3:], want[::2] + want[3:])):
            raise AssertionError(f"graph pass k={k}: node step differs from "
                                 f"sort-and-join")
        step_ms = _cuda_ms(lambda: kmer.union_ranks(prefix, suffix), repeats=10)
        step_sort_ms = _cuda_ms(lambda: sort_and_join(prefix, suffix), repeats=10)
        pass_ms = _cuda_ms(lambda: dbg.graph_unitig_pass(edges, counts, k), repeats=5)
        real_union_ranks = kmer.union_ranks
        kmer.union_ranks = sort_and_join
        try:
            pass_sort_ms = _cuda_ms(lambda: dbg.graph_unitig_pass(edges, counts, k),
                                    repeats=5)
        finally:
            kmer.union_ranks = real_union_ranks
        _log(f"K3 on the golden graph pass k={k} (W={W}, E={E}, {got[1]} nodes): "
             f"row-for-row equal; K3 alone {k3['ms']:.4f} ms (plain "
             f"{k3['plain_ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms); node step "
             f"{step_ms:.4f} ms with K3, "
             f"{step_sort_ms:.4f} ms with sort-and-join; graph pass {pass_ms:.4f} ms "
             f"with K3, {pass_sort_ms:.4f} ms with sort-and-join")
        results.append({**k3, "k": k, "W": W, "E": E, "step_ms": step_ms, "step_sort_ms": step_sort_ms,
                        "pass_ms": pass_ms, "pass_sort_ms": pass_sort_ms})
    return results


# ------------------------------------------------------------------ K4
GOLDEN_CHUNK_KEYS = 8192 * 129  # 150 bp reads padded to 160, 32-mer windows
DEFAULT_CHUNK_KEYS = 16384 * 225  # the default read_chunk and max_read_len 256


def check_sort2(dev) -> list:
    from mitoflex_tpu_torch.ops import psort

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    results = []
    for n in (1 << 20, GOLDEN_CHUNK_KEYS, DEFAULT_CHUNK_KEYS, 1 << 24):
        pool = torch.randint(-2**31, 2**31, (2, n // 3), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
        words = pool[:, torch.randint(0, n // 3, (n,), generator=gen, device=dev)]
        words[:, n // 5: n // 5 + n // 16] = -1  # all-ones keys (invalid windows)
        words = words.contiguous()
        got = psort.sort_words2(words)
        want = psort.sort_words2_ref(words)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise AssertionError(f"K4 disagrees with sort_words2_ref (n={n}): "
                                 f"max err {err}")
        del got, want
        ms = _cuda_ms(lambda: psort.sort_words2(words), repeats=10)
        plain_ms = _cuda_ms(lambda: psort.sort_words2_ref(words), repeats=10)
        # the plain version is one library call: torch.sort on the packed
        # 64-bit key, plus the gather
        bound_ms = 2 * _bound_ms(words)
        _log(f"K4 sort_words2 n={n}: equal; kernel {ms:.4f} ms, plain (torch.sort on "
             f"the packed key + gather) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms, "
             f"{n / ms / 1e6:.2f} Gkeys/s")
        results.append({"n": n, "max_abs_err": float(err), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "library_ms": plain_ms})
        del words
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- slice
def _fastq_pair(rng, tmp: str, genome: str, decoys, cov: int, decoy_cov: int,
                read_len: int, insert: int, error: float):
    from mitoflex_tpu_torch.testing import synth

    pairs = synth.shotgun_reads(rng, genome, len(genome) * cov // (2 * read_len),
                                read_len=read_len, insert=insert, circular=True,
                                error_rate=error)
    for g in decoys:
        pairs += synth.shotgun_reads(rng, g, len(g) * decoy_cov // (2 * read_len),
                                     read_len=read_len, insert=insert,
                                     error_rate=error)
    pairs = [pairs[i] for i in rng.permutation(len(pairs))]
    f1 = synth.write_fastq(os.path.join(tmp, "r1.fq"), [p[0] for p in pairs])
    f2 = synth.write_fastq(os.path.join(tmp, "r2.fq"), [p[1] for p in pairs])
    return f1, f2, sum(len(x[0]) + len(y[0]) for x, y in pairs)


def _planted_circle(fa_path: str, genome: str, klist):
    """(id, sequence without the duplication) of a contig flagged circular
    that is the genome up to rotation and strand after its (k-1)-base
    terminal duplication; None if there is none."""
    from mitoflex_tpu_torch.io import encoding, fasta

    doubled = genome + genome
    for rec in fasta.load_fasta(fa_path):
        if not rec.flag & 1:
            continue
        for k in klist:
            core = rec.seq[: len(rec.seq) - (k - 1)]
            if len(core) == len(genome) and (
                    core in doubled or encoding.revcomp_str(core) in doubled):
                return rec.id, core
    return None


def _slice_config(tmp: str, workname: str, golden: bool, fake):
    from mitoflex_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.run.basedir = tmp
    cfg.run.workname = workname
    cfg.run.profile_dir = fake.profile_dir
    cfg.search.disable_taxa = True
    cfg.search.min_abundance = 10
    cfg.annotate.clade = fake.clade
    cfg.annotate.genetic_code = 5
    if golden:
        cfg.filter.max_read_len = 160
        cfg.assemble.kmer_list = [31, 55, 91, 119]
        cfg.assemble.depth_list = [10, 20, 50, 50]
        cfg.assemble.read_chunk = 8192
    else:
        cfg.filter.batch_reads = 1024
        cfg.filter.max_read_len = 128
        cfg.assemble.kmer_list = [21, 41]
        cfg.assemble.depth_list = [5, 5]
        cfg.assemble.read_chunk = 1024
    return cfg


VITERBI_KERNELS = ("viterbi_scores_multi", "viterbi_scan")
# the search kernels: the two Viterbi passes and Smith-Waterman
SEARCH_KERNELS = VITERBI_KERNELS + ("sw_align",)
# and annotate's rRNA banded CYK and genewise
ANNOTATE_KERNELS = SEARCH_KERNELS + ("cyk_banded_device", "genewise_align")


def _launch_counters():
    from mitoflex_tpu_torch.ops import cyk_device, genewise, phmm, psort, sw
    from mitoflex_tpu_torch.ops import filter as F

    return {"filter_reads": F.filter_reads, "merge_sorted_runs": psort.merge_sorted_runs,
            "merge_sorted_runs_onepass": psort.merge_sorted_runs_onepass,
            "sort_words2": psort.sort_words2,
            "viterbi_scores_multi": phmm.viterbi_scores_multi,
            "viterbi_scan": phmm.viterbi_scan, "sw_align": sw.sw_align,
            "cyk_banded_device": cyk_device.cyk_banded_device,
            "genewise_align": genewise.genewise_align}


def _sort_launches(launches: dict) -> dict:
    """K1 to K4's counts: the paths without a search (filter and assemble)
    launch no Viterbi, Smith-Waterman, CYK or genewise kernel."""
    return {k: v for k, v in launches.items() if k not in ANNOTATE_KERNELS}


def _have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


TEXT_TRACKS = ("gene.txt", "features.txt", "depth.txt", "gc.txt", "karyotype.txt",
               "plus.txt", "tracks.json")
GOLDEN_COVERAGE = 400
DEPTH_MEAN_BAND = (0.7, 1.05)  # the filter and the errors take reads away; nothing adds any


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _check_tracks(prefix: str, picked_path: str, locs_path: str, what: str) -> dict:
    """The track files under ``prefix`` against the picked FASTA and
    ``locs.json``: one depth row per base, every gene in ``gene.txt``;
    returns ``tracks.json``."""
    from mitoflex_tpu_torch.io import fasta

    with open(f"{prefix}.tracks.json") as f:
        tracks = json.load(f)
    n_bases = sum(len(r.seq) for r in fasta.load_fasta(picked_path))
    n_rows = _read_bytes(f"{prefix}.depth.txt").count(b"\n")
    if n_rows != n_bases:
        raise AssertionError(f"{what}: depth.txt has {n_rows} rows for {n_bases} bases")
    with open(locs_path) as f:
        locs = json.load(f)
    rows = [ln.split("\t") for ln in _read_bytes(f"{prefix}.gene.txt").decode().splitlines()]
    names = {t["id"] for t in tracks["karyotype"]}
    for gene, v in locs.items():
        if not any(r[0] in names and r[1:] == [str(v[0]), str(v[1]), gene.split("_")[0]]
                   for r in rows):
            raise AssertionError(f"{what}: {gene} of locs.json has no row in gene.txt")
    return tracks


def run_golden_slice(seed: int, tmp: str):
    """Returns the launch counts, the graph passes' inputs ((edge_words,
    edge_counts, k) each) and the LSM merges' inputs ((a_keys, a_vals,
    b_keys, b_vals) each), both kept for phase 7, and the run's inputs,
    files and filter and assemble walls, for phase 12."""
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.io import fasta
    from mitoflex_tpu_torch.models import blast, nhmmer
    from mitoflex_tpu_torch.ops import cyk_device, dbg, genewise, mapper, phmm, psort, sw
    from mitoflex_tpu_torch.stages import visualize as vis
    from mitoflex_tpu_torch.testing import profile_fixture, synth

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    fake = profile_fixture.build(pathlib.Path(tmp), rng, spacer=2440, link_rna=True)
    genome = fake.genome
    decoys = [synth.random_genome(rng, 8000) for _ in range(2)]
    f1, f2, bases = _fastq_pair(rng, tmp, genome, decoys, cov=GOLDEN_COVERAGE, decoy_cov=12,
                                read_len=150, insert=300, error=0.01)
    _log(f"slice data: {len(genome)} bp genome with {len(profile_fixture.GENES)} PCGs, "
         f"{len(fake.rna_pos)} planted RNAs, "
         f"{bases} bases ({os.path.getsize(f1) * 2 >> 20} MiB FASTQ) made in "
         f"{time.perf_counter() - t0:.2f} s")
    cfg = _slice_config(tmp, "golden", True, fake)
    passes = []
    graph_pass = dbg.graph_unitig_pass

    def kept_graph_pass(edge_words, edge_counts, k):
        passes.append((edge_words.clone(), edge_counts.clone(), k))
        return graph_pass(edge_words, edge_counts, k)

    merges = []
    merge_runs = psort.merge_sorted_runs

    def kept_merge(a_keys, a_vals, b_keys, b_vals):
        merges.append(tuple(x.clone() for x in (a_keys, a_vals, b_keys, b_vals)))
        return merge_runs(a_keys, a_vals, b_keys, b_vals)

    # every Viterbi call's inputs, for phase 13; the plain loops must see no
    # card tensor
    real_viterbi = {n: getattr(phmm, n) for n in VITERBI_KERNELS}
    plain_names = ("viterbi_scores_multi_plain", "viterbi_scan_plain")
    real_plain = {n: getattr(phmm, n) for n in plain_names}
    viterbi_calls = {n: [] for n in VITERBI_KERNELS}
    plain_on_card = []

    def kept_viterbi(name):
        def run(prof, *a, **k):
            viterbi_calls[name].append((prof, *(x.clone() if isinstance(x, torch.Tensor)
                                                else x for x in a), k))
            return real_viterbi[name](prof, *a, **k)
        return run

    def watched_plain(name, fn):
        def run(*a, **k):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in a):
                plain_on_card.append(name)
            return fn(*a, **k)
        return run

    # every Smith-Waterman call's inputs and wall, for phase 14, and the
    # walls of blast's _batched_sw (padding, the SW calls, the copies back)
    # by the stage that called it; the plain loop must see no card tensor
    real_sw, real_sw_plain, real_batched = sw.sw_align, sw.sw_align_plain, blast._batched_sw
    sw_calls, sw_s, batched_s = [], {}, {}

    def kept_sw(*a, **k):
        sw_calls.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)
                        + (k,))
        t0 = time.perf_counter()
        out = real_sw(*a, **k)
        torch.cuda.synchronize()
        sw_s[current["stage"]] = sw_s.get(current["stage"], 0.0) + time.perf_counter() - t0
        return out

    def timed_batched_sw(*a, **k):
        t0 = time.perf_counter()
        out = real_batched(*a, **k)
        torch.cuda.synchronize()
        batched_s[current["stage"]] = (batched_s.get(current["stage"], 0.0)
                                       + time.perf_counter() - t0)
        return out

    # every banded CYK call's inputs and wall, for phase 15; its plain loop
    # must see no card
    real_cyk = cyk_device.cyk_banded_device
    real_cyk_plain = {n: getattr(cyk_device, n)
                      for n in ("cyk_banded_plain", "cyk_banded_maxima_plain")}
    cyk_calls = []

    def kept_cyk(model, window, anchor, slack=48, local=False, device=None):
        t0 = time.perf_counter()
        out = real_cyk(model, window, anchor, slack, local, device)
        torch.cuda.synchronize()
        cyk_calls.append((model, np.array(window), tuple(anchor), slack, local,
                          time.perf_counter() - t0))
        return out

    def watched_cyk_plain(name, fn):
        def run(model, window, anchor, slack=48, local=False, device=None):
            if torch.device(device if device is not None else "cuda").type == "cuda":
                plain_on_card.append(name)
            return fn(model, window, anchor, slack, local, device)
        return run

    # every genewise call's inputs and wall, for phase 16; its plain loop
    # must see no card tensor
    real_gw, real_gw_plain = genewise.genewise_align, genewise.genewise_align_plain
    genewise_calls, genewise_s = [], []

    def kept_genewise(*a, **k):
        genewise_calls.append((tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                     for x in a), dict(k)))
        t0 = time.perf_counter()
        out = real_gw(*a, **k)
        torch.cuda.synchronize()
        genewise_s.append(time.perf_counter() - t0)
        return out

    # nhmmer_search's walls by the stage that called it, and each call under
    # annotate with its models (the tRNA and rRNA searches' p7 filter scans)
    real_nhmmer = nhmmer.nhmmer_search
    nhmmer_s, annotate_nhmmer, current = {}, [], {"stage": None}
    nhmmer_calls = []

    def timed_nhmmer(contigs, profiles, *a, **k):
        nhmmer_calls.append((current["stage"], contigs, profiles, a, k))
        t0 = time.perf_counter()
        out = real_nhmmer(contigs, profiles, *a, **k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nhmmer_s[current["stage"]] = nhmmer_s.get(current["stage"], 0.0) + dt
        if current["stage"] == "run_annotate":
            annotate_nhmmer.append((len(profiles), max(h.length for h in profiles), dt))
        return out

    # each stage's wall (ending in a synchronise) and result, taken where
    # run_all calls the stage
    stages = ("run_filter", "run_assemble", "run_findmitoscaf", "run_annotate",
              "run_visualize")
    real_stages = {name: getattr(pipeline, name) for name in stages}
    stage_s, stage_out = {}, {}

    def timed_stage(name):
        def run(*a, **k):
            t0 = time.perf_counter()
            current["stage"] = name
            stage_out[name] = real_stages[name](*a, **k)
            torch.cuda.synchronize()
            current["stage"] = None
            stage_s[name] = time.perf_counter() - t0
            return stage_out[name]
        return run

    remap = {}
    coverage_of_reads = mapper.coverage_of_reads

    def timed_coverage(*a, **k):
        t0 = time.perf_counter()
        out = coverage_of_reads(*a, **k)
        torch.cuda.synchronize()
        remap.update(s=time.perf_counter() - t0, mapped=out[2], reads=out[3])
        return out

    have_mpl = _have_matplotlib()
    if not have_mpl:
        _log("matplotlib cannot be imported here: `all` runs with "
             "disable_visualization and the visualize stage's build_tracks (rename, "
             "depth remap on the card, GC windows, tracks.json, circos files) is "
             "called directly; no figure is rendered")
        cfg.visualize.disable_visualization = True
    # the wrapper counts on the module attribute of its own name, which is
    # the recording function while this run lasts
    recorders = {n: kept_viterbi(n) for n in VITERBI_KERNELS}
    counters = {**_launch_counters(), "merge_sorted_runs": kept_merge, **recorders,
                "sw_align": kept_sw, "cyk_banded_device": kept_cyk,
                "genewise_align": kept_genewise}
    ctx = pipeline.PipelineContext.create(cfg, device="cuda")
    dbg.graph_unitig_pass = kept_graph_pass
    psort.merge_sorted_runs = kept_merge
    mapper.coverage_of_reads = timed_coverage
    nhmmer.nhmmer_search = timed_nhmmer
    for n in VITERBI_KERNELS:
        setattr(phmm, n, recorders[n])
    for n in plain_names:
        setattr(phmm, n, watched_plain(n, real_plain[n]))
    sw.sw_align, blast._batched_sw = kept_sw, timed_batched_sw
    sw.sw_align_plain = watched_plain("sw_align_plain", real_sw_plain)
    cyk_device.cyk_banded_device = kept_cyk
    for n, fn in real_cyk_plain.items():
        setattr(cyk_device, n, watched_cyk_plain(n, fn))
    genewise.genewise_align = kept_genewise
    genewise.genewise_align_plain = watched_plain("genewise_align_plain", real_gw_plain)
    for name in stages:
        setattr(pipeline, name, timed_stage(name))
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        summary = pipeline.run_all(ctx, f1, f2)
        torch.cuda.synchronize()
        all_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        res, found = stage_out["run_filter"], stage_out["run_findmitoscaf"]
        annotated = stage_out["run_annotate"]
        prefix = os.path.join(ctx.workdir.stage_dir("visualize"), cfg.run.workname)
        if not have_mpl:
            t0 = time.perf_counter()
            vis.build_tracks(cfg.visualize, fasta.load_fasta(found.path), annotated.locs,
                             prefix, res.clean1, res.clean2,
                             circular=annotated.circular, device="cuda")
            torch.cuda.synchronize()
            stage_s["run_visualize"] = time.perf_counter() - t0
    finally:
        dbg.graph_unitig_pass = graph_pass
        psort.merge_sorted_runs = merge_runs
        mapper.coverage_of_reads = coverage_of_reads
        nhmmer.nhmmer_search = real_nhmmer
        for n, fn in {**real_viterbi, **real_plain}.items():
            setattr(phmm, n, fn)
        sw.sw_align, sw.sw_align_plain, blast._batched_sw = real_sw, real_sw_plain, real_batched
        cyk_device.cyk_banded_device = real_cyk
        for n, fn in real_cyk_plain.items():
            setattr(cyk_device, n, fn)
        genewise.genewise_align, genewise.genewise_align_plain = real_gw, real_gw_plain
        for name in stages:
            setattr(pipeline, name, real_stages[name])
    filter_s, assemble_s, find_s, annotate_s, visualize_s = (stage_s[n] for n in stages)
    w = found.walls
    aw = annotated.walls
    cyk_s = sum(c[-1] for c in cyk_calls)
    cyk_list = [(m.name, m.n_states, len(w), round(dt, 4)) for m, w, *_, dt in cyk_calls]
    trna_p7 = sum(dt for n, L, dt in annotate_nhmmer if L <= 200)
    rrna_p7 = sum(dt for n, L, dt in annotate_nhmmer if L > 200)
    _log(f"nhmmer_search walls by stage: "
         + ", ".join(f"{k}: {v:.3f} s" for k, v in nhmmer_s.items())
         + f"; under annotate {len(annotate_nhmmer)} calls (models, longest model, s): "
         f"{[(n, L, round(dt, 4)) for n, L, dt in annotate_nhmmer]}: tRNA wall "
         f"{aw['trna']:.3f} s = p7 filter scan {trna_p7:.3f} s + CYK refinement and the "
         f"rest {aw['trna'] - trna_p7:.3f} s; rRNA wall {aw['rrna']:.3f} s = p7 filter "
         f"scan {rrna_p7:.3f} s + banded CYK and the rest {aw['rrna'] - rrna_p7:.3f} s, of "
         f"which the {len(cyk_calls)} cyk_banded_device calls {cyk_s:.4f} s (model, "
         f"states, window, s: {cyk_list})")
    tbl = aw["tblastn"]
    tbl_batched, tbl_sw = batched_s.get("run_annotate", 0.0), sw_s.get("run_annotate", 0.0)
    _log(f"Smith-Waterman: {len(sw_calls)} sw_align calls, walls by stage "
         + ", ".join(f"{k}: {v:.4f} s" for k, v in sw_s.items())
         + f"; annotate's tblastn wall {tbl:.3f} s = _batched_sw {tbl_batched:.4f} s (of "
         f"which the sw_align calls {tbl_sw:.4f} s, the rest padding and copies) + host "
         f"work (seed join, windows, hit table) {tbl - tbl_batched:.3f} s; findmitoscaf's "
         f"_batched_sw {batched_s.get('run_findmitoscaf', 0.0):.4f} s")
    gw_shapes = [f"{a[0].shape[0]} hits x Lq {a[0].shape[1]} x T {a[2].shape[1]}"
                 for a, _ in genewise_calls]
    _log(f"genewise: {len(genewise_calls)} genewise_align calls ({', '.join(gw_shapes)}), "
         f"{sum(genewise_s):.4f} s of annotate's genewise wall {aw['genewise']:.3f} s (the "
         f"rest: windows, translation, copies); genewise kernel launches "
         f"{launches['genewise_align']}, "
         f"{launches['genewise_align'] / max(len(genewise_calls), 1):g} a call")
    if plain_on_card:
        raise AssertionError(f"golden all: the plain Viterbi, SW, CYK or genewise loops ran "
                             f"on the card: {sorted(set(plain_on_card))}")
    _log(f"all walls: run_all {all_s:.3f} s"
         + ("" if have_mpl else " (without visualize)")
         + f"; filter {filter_s:.3f} s ({res.reads_kept}/{res.reads_in} "
         f"pairs kept), assemble {assemble_s:.3f} s (incl. local extension and "
         f"scaffolding), findmitoscaf {find_s:.3f} s (nhmmer {w['nhmmer']:.3f} s, "
         f"blastn/tblastn with SW {w['blast']:.3f} s, rest "
         f"{find_s - w['nhmmer'] - w['blast']:.3f} s), annotate {annotate_s:.3f} s "
         f"(tblastn {annotated.walls['tblastn']:.3f} s, genewise "
         f"{annotated.walls['genewise']:.3f} s, tRNA {annotated.walls['trna']:.3f} s, "
         f"rRNA {annotated.walls['rrna']:.3f} s, rest "
         f"{annotate_s - sum(annotated.walls.values()):.3f} s), visualize "
         f"{visualize_s:.3f} s ({'tracks and figure' if have_mpl else 'tracks only'}; "
         f"depth remap {remap['s']:.3f} s for {remap['reads']} reads, "
         f"{remap['mapped']} mapped, {remap['reads'] / remap['s']:.0f} reads/s); "
         f"kernel launches "
         f"{json.dumps(launches)}; peak device memory "
         f"{torch.cuda.max_memory_allocated() >> 20} MiB")
    want_keys = ["picked", "locs", "circular"] + (["plots"] if have_mpl else [])
    if list(summary) != want_keys or summary["circular"] is not True \
            or summary["picked"] != found.path or summary["locs"] != annotated.path:
        raise AssertionError(f"run_all summary {summary}, expected keys {want_keys} "
                             f"and a circular genome")
    if have_mpl:
        plots = summary["plots"]
        if plots != [f"{prefix}.png"] or not all(
                os.path.getsize(p) > 0 for p in (
                    plots[0], f"{prefix}.svg",
                    ctx.workdir.result_file(f"{cfg.run.workname}.png"),
                    ctx.workdir.result_file(f"{cfg.run.workname}.svg"))):
            raise AssertionError(f"run_all plots {plots}: PNG or SVG missing")
    tracks = _check_tracks(prefix, found.path, annotated.path, "golden all")
    depth_mean = tracks["depth_mean"]["mt1"]
    lo, hi = (x * GOLDEN_COVERAGE for x in DEPTH_MEAN_BAND)
    if not lo <= depth_mean <= hi:
        raise AssertionError(f"golden all: depth_mean of mt1 {depth_mean} outside "
                             f"[{lo}, {hi}]")
    _log(f"all summary: keys {list(summary)}, circular {summary['circular']}; "
         f"tracks.json depth_mean mt1 {depth_mean:.1f} (planted {GOLDEN_COVERAGE}x, "
         f"band {lo:.0f}-{hi:.0f}); depth.txt one row per base; every gene of "
         f"locs.json in gene.txt")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    hit = _planted_circle(found.path, genome, cfg.assemble.kmer_list)
    if not hit:
        raise AssertionError(f"no circular scaffold equals the planted genome in "
                             f"{found.path}")
    manifest = ctx.workdir.read_manifest("findmitoscaf")
    if manifest["found_pcgs"] != profile_fixture.GENES or manifest["missing_pcgs"]:
        raise AssertionError(f"PCGs found {manifest['found_pcgs']}, missing "
                             f"{manifest['missing_pcgs']}")
    _log(f"slice output: picked scaffold {hit[0]} is the planted {len(genome)} bp circle "
         f"(rotation/strand, after the terminal duplication); PCGs found "
         f"{manifest['found_pcgs']}")
    _check_annotation(fake, os.path.dirname(annotated.path), cfg.run.workname,
                      "golden slice", hit[1])
    golden = {"fake": fake, "f1": f1, "f2": f2, "clean1": res.clean1, "clean2": res.clean2,
              "contigs": ctx.workdir.stage_file("assemble", "contigs.fa"),
              "assembled": stage_out["run_assemble"], "filter_s": filter_s,
              "assemble_s": assemble_s, "viterbi_calls": viterbi_calls,
              "nhmmer_calls": nhmmer_calls, "sw_calls": sw_calls,
              "cyk_calls": [c[:-1] for c in cyk_calls], "genewise_calls": genewise_calls}
    return launches, passes, merges, golden


ANNOTATION_TOL_CODONS = 2


def _check_annotation(fake, stage_dir: str, workname: str, what: str,
                      scaffold: str) -> None:
    """``locs.json`` lists every planted gene under its name, on its
    planted strand, and its annotated fragment is the planted sequence
    within ANNOTATION_TOL_CODONS codons at either end (which fixes its
    start and end up to the circle's rotation). ``scaffold`` is the picked
    circle as it was linearised; the one gene that its two ends may cut in
    two is named and left out."""
    from mitoflex_tpu_torch.io import encoding, fasta

    with open(os.path.join(stage_dir, "locs.json")) as f:
        locs = json.load(f)
    frags = {}
    for kind in ("cds", "rna"):
        for rec in fasta.load_fasta(os.path.join(
                stage_dir, f"{workname}.annotated.{kind}.fa")):
            frags[str(rec.attrs["gene"])] = rec.seq
    tol = 3 * ANNOTATION_TOL_CODONS
    planted = {**fake.gene_pos, **fake.rna_pos}
    orientation, worst, cut = set(), 0, []
    for gene, (s, e, strand) in planted.items():
        whole = fake.genome[s:e]
        if whole not in scaffold and encoding.revcomp_str(whole) not in scaffold:
            cut.append(gene)
            continue
        if gene not in locs or gene not in frags:
            raise AssertionError(f"{what}: planted {gene} missing from locs.json "
                                 f"(has {sorted(locs)})")
        want = fake.genome[s:e]
        core = want[tol: len(want) - tol]
        frag = frags[gene]
        if core in frag:
            o = 1
        elif encoding.revcomp_str(core) in frag:
            o = -1
        else:
            raise AssertionError(f"{what}: the fragment annotated as {gene} is not "
                                 f"the planted sequence")
        if abs(len(frag) - len(want)) > 2 * tol:
            raise AssertionError(f"{what}: {gene} annotated {len(frag)} bp, planted "
                                 f"{len(want)} bp")
        start, end, kind, _, sign = locs[gene]
        if end - start + 1 != len(frag) or (sign == "+") != (strand * o > 0):
            raise AssertionError(f"{what}: {gene} at {locs[gene]} does not match its "
                                 f"fragment or its planted strand")
        want_kind = 0 if gene in fake.gene_pos else (2 if gene.startswith("rrn") else 1)
        if kind != want_kind:
            raise AssertionError(f"{what}: {gene} has type {kind}")
        orientation.add(o)
        worst = max(worst, abs(len(frag) - len(want)))
    if len(orientation) != 1 or len(cut) > 1:
        raise AssertionError(f"{what}: genes disagree on the scaffold's orientation, "
                             f"or more than one is cut by its ends: {cut}")
    extra = sorted(set(locs) - set(planted))
    _log(f"{what} annotation: locs.json lists {len(planted) - len(cut)} of "
         f"{len(planted)} planted genes ({sorted(set(planted) - set(cut))}; cut in two "
         f"by the linearised circle's ends: {cut}) on their planted strands, "
         f"fragments equal to the "
         f"planted sequences within {ANNOTATION_TOL_CODONS} codons at either end "
         f"(largest length difference {worst} nt); other entries: {extra}")


def make_small_reads(seed: int, tmp: str):
    """The small read set of phases 8, 10 and 11: the profile fixture's
    genome with small covariance models at 60x plus a decoy, 100 bp pairs."""
    from mitoflex_tpu_torch.testing import profile_fixture, synth

    rng = np.random.default_rng(seed + 1)
    fake = profile_fixture.build(pathlib.Path(tmp) / "small", rng, spacer=600,
                                 link_rna=True, rrna_clen=(200, 230))
    decoys = [synth.random_genome(rng, 1500)]
    f1, f2, _ = _fastq_pair(rng, tmp, fake.genome, decoys, cov=60, decoy_cov=20,
                            read_len=100, insert=300, error=0.005)
    return fake, f1, f2


# ------------------------------------------------- command line and bim
class _Command:
    """One ``python3 -m <module> <args>`` subprocess whose output goes to
    files under ``tmp``; ``finish`` waits for it and returns (exit code,
    stdout, stderr), ``kill`` ends it if it still runs."""

    def __init__(self, tmp: str, name: str, module: str, args, threads: int = 0):
        """``threads`` > 0 caps the command's CPU threads, for a command that
        runs beside other work on the same cores."""
        self.name = name
        self._out = open(os.path.join(tmp, f"{name}.stdout"), "w+")
        self._err = open(os.path.join(tmp, f"{name}.stderr"), "w+")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            x for x in (REPO, env.get("PYTHONPATH")) if x)
        if threads:
            env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(threads)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=tmp,
                                     env=env, stdout=self._out, stderr=self._err)

    def finish(self, timeout: float = 600):
        try:
            rc = self.proc.wait(timeout)
        finally:
            self.kill()
        self.seconds = time.perf_counter() - self.t0
        texts = []
        for f in (self._out, self._err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        return rc, texts[0], texts[1]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _must_exit(cmd: _Command, code: int = 0):
    rc, out, err = cmd.finish()
    if rc != code:
        raise AssertionError(f"{cmd.name}: exit {rc}, expected {code}\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    return out, err


def _json_line(out: str, key: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{") and f'"{key}"' in ln]
    if len(lines) != 1:
        raise AssertionError(f"expected one JSON line with {key!r} in:\n{out[-2000:]}")
    return json.loads(lines[0])


def _small_cli_args(fake, f1: str, f2: str, basedir: str):
    """The small slice's settings (``_slice_config``) as command-line flags."""
    return ["--fastq1", f1, "--fastq2", f2, "--workname", "cli", "--basedir", basedir,
            "--profile-dir", fake.profile_dir, "--clade", fake.clade,
            "--genetic-code", "5", "--disable-taxa", "--min-abundance", "10",
            "--kmer-list", "21,41", "--depth-list", "5,5"]


CPU_COMMAND_THREADS = 4  # a CPU command runs beside one on the card


class _SmallRuns:
    """Where phase 8's two command-line runs left their files."""

    def __init__(self, tmp: str):
        self.base = {"card": os.path.join(tmp, "cli_card"),
                     "cpu": os.path.join(tmp, "cli_cpu")}
        self.card_args: list = []   # the card run's flags, for the resume run
        self.summary: dict = {}     # the JSON line the card run printed
        self.card_out = ""          # the card run's standard output

    def stage(self, side: str, name: str, f: str) -> str:
        return os.path.join(self.base[side], "cli", "cli.temp", name, f)


def run_small_all_vs_cpu(tmp: str, fake, f1: str, f2: str, have_mpl: bool,
                         card_device=()) -> _SmallRuns:
    """Phase 8: ``all`` through the command line on the card and with
    ``--device cpu``, started together. ``card_device`` is empty on the card
    (no ``--device``: the default must be the card); a rehearsal without a
    card passes ``("--device", "cpu")``."""
    from mitoflex_tpu_torch.config import VisualizeConfig
    from mitoflex_tpu_torch.io import fasta
    from mitoflex_tpu_torch.stages import visualize as vis

    novis = [] if have_mpl else ["--disable-visualization"]
    runs = _SmallRuns(tmp)
    runs.card_args = [*_small_cli_args(fake, f1, f2, runs.base["card"]), *card_device,
                      *novis]
    card = _Command(tmp, "cli_all_card", "mitoflex_tpu_torch",
                    ["all", *runs.card_args, "--keep-temp"])
    cpu = _Command(tmp, "cli_all_cpu", "mitoflex_tpu_torch",
                   ["all", *_small_cli_args(fake, f1, f2, runs.base["cpu"]),
                    "--keep-temp", "--device", "cpu", *novis],
                   threads=CPU_COMMAND_THREADS)
    try:
        out, _ = _must_exit(card)
        _must_exit(cpu)
    finally:
        cpu.kill()
    runs.summary = _json_line(out, "picked")
    runs.card_out = out
    if "pipeline: device cuda" not in out and not card_device:
        raise AssertionError("`all` without --device did not run on the card")
    want_keys = ["picked", "locs", "circular"] + (["plots"] if have_mpl else [])
    if list(runs.summary) != want_keys:
        raise AssertionError(f"`all` printed {runs.summary}")
    stage = runs.stage
    picked = stage("card", "findmitoscaf", "cli.picked.fa")
    circle = _planted_circle(picked, fake.genome, [21, 41])
    if circle is None:
        raise AssertionError("small slice: planted circle not picked")
    _check_annotation(fake, os.path.dirname(stage("card", "annotation", "locs.json")),
                      "cli", "small slice", circle[1])
    if not have_mpl:
        # the tracks part of the stage, called directly on each run's files
        for side, device in (("card", card_device[1] if card_device else "cuda"),
                             ("cpu", "cpu")):
            with open(stage(side, "annotation", "locs.json")) as f:
                locs = json.load(f)
            vis.build_tracks(
                VisualizeConfig(),
                fasta.load_fasta(stage(side, "findmitoscaf", "cli.picked.fa")), locs,
                stage(side, "visualize", "cli"), stage(side, "cleandata", "clean.1.fq"),
                stage(side, "cleandata", "clean.2.fq"), device=device)
    contigs = {side: os.path.basename(json.loads(_read_bytes(
        stage(side, "assemble", "manifest.json")))["outputs"][0]) for side in runs.base}
    if contigs["card"] != contigs["cpu"]:
        raise AssertionError(f"small slice: assemble wrote {contigs}")
    compared = [("cleandata", "clean.1.fq"), ("cleandata", "clean.2.fq"),
                ("assemble", contigs["card"]), ("findmitoscaf", "cli.picked.fa"),
                ("annotation", "locs.json"), ("annotation", "cli.annotated.cds.fa"),
                ("annotation", "cli.annotated.rna.fa"), ("annotation", "cli.wise.csv"),
                *(("visualize", f"cli.{t}") for t in TEXT_TRACKS)]
    for name, f in compared:
        if _read_bytes(stage("card", name, f)) != _read_bytes(stage("cpu", name, f)):
            raise AssertionError(f"small slice: {f} differs between the card and "
                                 f"--device cpu")
    conf = [_read_bytes(stage(side, "visualize", "cli.circos.conf")).decode().replace(
        runs.base[side], "<BASE>") for side in ("card", "cpu")]
    if conf[0] != conf[1] or "<BASE>" not in conf[0]:
        raise AssertionError("small slice: circos.conf differs beyond the directory")
    _check_tracks(stage("card", "visualize", "cli"), picked,
                  stage("card", "annotation", "locs.json"), "small slice")
    _log(f"small slice, `all` through the command line: exit 0 on the card "
         f"({card.seconds:.1f} s, no --device) and with --device cpu ({cpu.seconds:.1f} "
         f"s, {CPU_COMMAND_THREADS} threads, beside the card's); clean FASTQs, "
         f"{contigs['card']}, picked FASTA, locs.json, both annotated FASTAs, wise.csv "
         f"and the {len(TEXT_TRACKS)} text track files byte-identical, circos.conf equal "
         f"up to the directory"
         + ("" if have_mpl else " (tracks from build_tracks called directly: no "
                               "matplotlib)"))
    return runs


def run_command_line_rest(tmp: str, fake, f1: str, f2: str, runs: _SmallRuns,
                          have_mpl: bool, card_device=()) -> _Command:
    """Phase 10: ``visualize`` alone, ``check_circular`` and ``all --resume``
    on phase 8's card run; returns phase 11's ``bim --device cpu``, started
    beside the resume run."""
    stage = runs.stage
    picked = stage("card", "findmitoscaf", "cli.picked.fa")
    circle = _planted_circle(picked, fake.genome, [21, 41])
    # visualize alone, with --locs and the clean reads; check_circular beside it
    vis_cmd = _Command(tmp, "cli_visualize", "mitoflex_tpu_torch", [
        "visualize", "--fastafile", picked, "--locs",
        stage("card", "annotation", "locs.json"),
        "--fastq1", stage("card", "cleandata", "clean.1.fq"),
        "--fastq2", stage("card", "cleandata", "clean.2.fq"), "--workname", "cli",
        "--basedir", os.path.join(tmp, "cli_vis"), "--disable-taxa", *card_device])
    cc = _Command(tmp, "cli_check_circular", "mitoflex_tpu_torch.check_circular",
                  ["--fasta", picked, "--length", "1000"])
    alone = os.path.join(tmp, "cli_vis", "cli", "cli.temp", "visualize")
    try:
        if have_mpl:
            out, _ = _must_exit(vis_cmd)
            outs = _json_line(out, "outputs")["outputs"]
            if len(outs) != 10 or not all(os.path.getsize(o) > 0 for o in outs):
                raise AssertionError(f"`visualize` wrote {outs}")
            for t in TEXT_TRACKS:
                if _read_bytes(os.path.join(alone, f"cli.{t}")) != _read_bytes(
                        stage("card", "visualize", f"cli.{t}")):
                    raise AssertionError(f"`visualize` alone: {t} differs from the all "
                                         f"run's")
            _log(f"command line `visualize` alone: exit 0 ({vis_cmd.seconds:.1f} s), PNG, "
                 f"SVG and the track files of the `all` run, byte for byte")
        else:
            out, err = _must_exit(vis_cmd, 2)
            if "matplotlib" not in out + err or os.listdir(alone):
                raise AssertionError(f"`visualize` without matplotlib must name it and "
                                     f"write nothing:\n{err[-2000:]}")
            _log(f"command line `visualize` alone: matplotlib is missing here, so the "
                 f"command exits 2, names it and writes nothing ({vis_cmd.seconds:.1f} s)")
        out, _ = _must_exit(cc)
    finally:
        cc.kill()
    called = json.loads(out)
    if not called.get(circle[0]) or called[circle[0]][2] < 40:
        raise AssertionError(f"check_circular on the picked FASTA: {called}")
    _log(f"command line check_circular (run beside `visualize`): {circle[0]} "
         f"circular, overlap {called[circle[0]][2]}")

    # resume on the card's work directory, without --keep-temp
    cpu_bim = _Command(tmp, "cli_bim_cpu", "mitoflex_tpu_torch",
                       ["bim", *_small_cli_args(fake, f1, f2, os.path.join(tmp, "bim_cpu")),
                        *BIM_FLAGS, "--device", "cpu"], threads=CPU_COMMAND_THREADS)
    try:
        _check_resume(tmp, runs, have_mpl)
    except BaseException:
        cpu_bim.kill()
        raise
    return cpu_bim


def _check_resume(tmp: str, runs: _SmallRuns, have_mpl: bool) -> None:
    resume = _Command(tmp, "cli_all_resume", "mitoflex_tpu_torch",
                      ["all", *runs.card_args, "--resume"])
    out, _ = _must_exit(resume)
    again = _json_line(out, "picked")
    for name in ("cleandata", "assemble", "findmitoscaf"):
        if f"resume: skipping {name}" not in out:
            raise AssertionError(f"`all --resume` did not skip {name}")
    if out.count("resume: skipping") != 3 or again != runs.summary:
        raise AssertionError(f"`all --resume`: summary {again}, "
                             f"{out.count('resume: skipping')} stages skipped")
    root = os.path.join(runs.base["card"], "cli")
    results = sorted(os.listdir(os.path.join(root, "cli.result")))
    want = sorted(["cli.picked.fa", "locs.json", "cli.annotated.cds.fa",
                   "cli.annotated.rna.fa"] + (["cli.png", "cli.svg"] if have_mpl else []))
    if os.path.exists(os.path.join(root, "cli.temp")) or results != want:
        raise AssertionError(f"`all --resume` without --keep-temp left cli.temp or the "
                             f"results {results}")
    _log(f"command line `all --resume` (no --keep-temp): exit 0 ({resume.seconds:.1f} "
         f"s), cleandata, assemble and findmitoscaf skipped, annotate"
         + (" and visualize" if have_mpl else "")
         + f" rerun, same summary; stage directories removed, results {results}")


BIM_FLAGS = ["--max-iteration", "2", "--iteration-ignore", "0"]


def run_bim_vs_cpu(tmp: str, fake, f1: str, f2: str, cpu_bim: _Command,
                   device: str = "cuda") -> dict:
    """Phase 11; returns the card run's launch counts."""
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.io import encoding, fasta, fastq
    from mitoflex_tpu_torch.ops import mapper

    cfg = _slice_config(os.path.join(tmp, "bim_card"), "cli", False, fake)
    # the command line's defaults where _slice_config narrows them, so that
    # both sides read the same configuration
    cfg.filter.batch_reads = type(cfg.filter)().batch_reads
    cfg.filter.max_read_len = type(cfg.filter)().max_read_len
    cfg.assemble.read_chunk = type(cfg.assemble)().read_chunk
    cfg.bim.max_iteration, cfg.bim.iteration_ignore = 2, 0
    ctx = pipeline.PipelineContext.create(cfg, device=device)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    picked = pipeline.run_bim(ctx, f1, f2)
    if device != "cpu":
        torch.cuda.synchronize()
    bim_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if device != "cpu" and min(_sort_launches(launches).values()) <= 0:
        raise AssertionError(f"bim: a kernel never launched: {launches}")
    if cfg.assemble.disable_scaffolding or not picked.endswith("cli.picked.fa"):
        raise AssertionError(f"bim: returned {picked}, disable_scaffolding "
                             f"{cfg.assemble.disable_scaffolding}")
    out, _ = _must_exit(cpu_bim)
    cpu_picked = _json_line(out, "picked")["picked"]
    if _read_bytes(picked) != _read_bytes(cpu_picked):
        raise AssertionError("bim: picked FASTA differs between the card and the CPU")
    best = max(fasta.load_fasta(picked), key=lambda r: len(r.seq))
    doubled = fake.genome + fake.genome
    if not (best.seq in doubled or encoding.revcomp_str(best.seq) in doubled) \
            or len(best.seq) <= len(fake.genome) - 50:
        raise AssertionError(f"bim: longest picked record ({len(best.seq)} bp) is not "
                             f"the planted {len(fake.genome)} bp genome")
    # generation 0's bait mapping again, alone: the initial assembly as bait,
    # the clean pairs in batches of 8192, as run_bim maps them
    wd = ctx.workdir
    clean = wd.read_manifest("cleandata")["outputs"]
    bait = fasta.load_fasta(wd.read_manifest("assemble")["outputs"][0])
    t0 = time.perf_counter()
    index = mapper.ContigIndex.build(bait, ctx.device)
    n_reads = n_kept = 0
    for p1, p2 in fastq.read_pair_batches(clean[0], clean[1], 8192,
                                          cfg.filter.max_read_len, keep_names=True):
        m1 = mapper.map_batch(index, p1.seqs[: p1.count], p1.lengths[: p1.count])
        m2 = mapper.map_batch(index, p2.seqs[: p2.count], p2.lengths[: p2.count])
        n_kept += int(((m1.contig >= 0) | (m2.contig >= 0)).sum())
        n_reads += 2 * p1.count
    map_s = time.perf_counter() - t0
    baited = _read_bytes(wd.stage_file("assemble", "bim.0.1.fq")).count(b"\n") // 4
    if n_kept != baited or baited == 0:
        raise AssertionError(f"bim: {n_kept} pairs kept by the repeated bait mapping, "
                             f"{baited} written by generation 0")
    _log(f"bim: 2 generations in {bim_s:.3f} s on {device} ({bim_s / 2:.3f} s a "
         f"generation, the first filter and assembly included; CPU through the command "
         f"line {cpu_bim.seconds:.1f} s); picked FASTA byte-identical, longest record "
         f"{len(best.seq)} bp of the planted {len(fake.genome)} bp genome; kernel "
         f"launches {json.dumps(launches)}; bait mapping of generation 0 alone: "
         f"{n_reads} reads against {len(bait)} contigs in {map_s:.3f} s, "
         f"{n_reads / map_s:.0f} reads/s, {baited} pairs kept")
    return launches


# ------------------------------------------------------------- genewise
GENEWISE_SCORE_TOL = 1e-4   # the same float32 terms on both devices


# the calls of the CUDA runtime API (cuda*) and of the lower-level cu* API
# that launch a kernel, as torch.profiler names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
               "cudaLaunchCooperativeKernelMultiDevice", "cuLaunchKernel", "cuLaunchKernelEx",
               "cuLaunchCooperativeKernel", "cuLaunchCooperativeKernelMultiDevice")


def _launch_count(events) -> int:
    """Kernel launches among profiler events (``key_averages()``), by every
    launch call of LAUNCH_APIS (a versioned name such as
    ``cudaLaunchKernel_v7000`` counts as its call)."""
    return sum(e.count for e in events if re.sub(r"_v\d+$", "", e.key) in LAUNCH_APIS)


def _wall_ms_and_launches(fn, count_launches: bool = True):
    """(milliseconds of one call on the host clock, ending in a
    synchronise, after a warm-up call; kernel launches of one call, by any
    launch call of LAUNCH_APIS, or None where they were not counted or the
    profiler reports none). Counting costs about a millisecond of profiler
    time per launch, so the calls of tens of thousands of launches leave it
    out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not count_launches:
        return ms, None
    import torch.profiler as tp

    with tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return ms, (_launch_count(prof.key_averages()) or None)


GOLDEN_REPEATS = 3


def _golden_replay(name: str, calls: list, run, describe=None) -> dict:
    """Every call the golden run made of kernel ``name`` through its wrapper
    again (``run(call)``): the launches of one replay of them all on the
    wrapper's own counter (``replay_launches``, which only phase 15's check
    reads), and the sum over the calls of each call's median of
    GOLDEN_REPEATS CUDA-event-timed calls after a warm-up
    (``golden_sum_ms``); ``describe(call, ms)``, where given, is logged for
    every call."""
    counter = _launch_counters()[name]
    before = counter.launches
    for c in calls:
        run(c)
    torch.cuda.synchronize()
    launches = counter.launches - before
    times = [_cuda_ms(lambda: run(c), GOLDEN_REPEATS) for c in calls]
    if describe is not None:
        for i, (c, ms) in enumerate(zip(calls, times)):
            _log(f"  {name} golden call {i}: {describe(c, ms)}")
    total = sum(times)
    _log(f"golden run's {len(calls)} {name} calls replayed: {launches} kernel launches, "
         f"{total:.4f} ms summed (each call's median of {GOLDEN_REPEATS})")
    return {"golden_calls": len(calls), "replay_launches": launches, "golden_sum_ms": total}


def _random_dna(rng, n: int) -> str:
    return "".join("ACGT"[int(i)] for i in rng.integers(0, 4, n))


def _genewise_batch():
    """Seeded genewise hits: ``(kinds, (qa, ql, aa, tl))`` with frameshifts
    +1, -1, +2, in-frame stops and a gene planted twice."""
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.ops import genewise

    rng = np.random.default_rng(17)
    gc = codon.get_code(5)
    codons = [c for c, a in sorted(gc.forward.items()) if a != "*"]
    stop = next(c for c, a in sorted(gc.forward.items()) if a == "*")
    kinds = ["clean", "plus1", "minus1", "plus2", "stop", "twice"] * 4
    q_rows, t_rows = [], []
    for kind in kinds:
        n = int(rng.integers(80, 110))
        nt = "".join(codons[int(i)] for i in rng.integers(0, len(codons), n))
        q_rows.append(codon.aa_encode(gc.translate_str(nt)))
        mid = 3 * (n // 2)
        if kind == "plus1":
            nt = nt[:mid] + "A" + nt[mid:]
        elif kind == "minus1":
            nt = nt[:mid] + nt[mid + 1:]
        elif kind == "plus2":
            nt = nt[:mid] + "CA" + nt[mid:]
        elif kind == "stop":
            nt = nt[:mid] + stop + nt[mid + 3:]
        elif kind == "twice":     # two equal maxima: the first must win
            nt = nt + _random_dna(rng, 30) + nt
        t_rows.append(encoding.encode(_random_dna(rng, 30) + nt + _random_dna(rng, 30)))
    B = len(kinds)
    qa = np.full((B, max(map(len, q_rows))), codon.X_CODE, np.int8)
    ta = np.full((B, max(map(len, t_rows))), 4, np.int8)
    ql, tl = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for i, (q, t) in enumerate(zip(q_rows, t_rows)):
        qa[i, : len(q)], ta[i, : len(t)] = q, t
        ql[i], tl[i] = len(q), len(t)
    return kinds, (qa, ql, genewise.translate_windows(ta, 5), tl)


def check_genewise_vs_cpu(dev) -> None:
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.ops import genewise

    kinds, (qa, ql, aa, tl) = _genewise_batch()
    B = len(kinds)

    def run(device):
        return genewise.genewise_align(
            *(torch.from_numpy(x).to(device) for x in (qa, ql, aa, tl)), codon.blosum62())

    got, want = run(dev), run("cpu")
    for f in ("q_from", "q_to", "t_from", "t_to", "n_shift"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
            raise AssertionError(f"genewise_align: {f} differs between CUDA and CPU")
    err = float((got.score.cpu() - want.score).abs().max())
    shifted = [i for i, k in enumerate(kinds) if k in ("plus1", "minus1", "plus2")]
    if err > GENEWISE_SCORE_TOL or int(want.n_shift[shifted].min()) < 1 \
            or float(want.score.min()) < 100:
        raise AssertionError(f"genewise_align: score error {err}, frameshifts "
                             f"{want.n_shift.tolist()}")
    ms, launches = _wall_ms_and_launches(lambda: run(dev))
    _log(f"genewise_align on the card against the CPU: {B} hits x {qa.shape[1]} aa x "
         f"{int(tl.max())} nt (frameshifts +1, -1, +2, in-frame stops, a gene planted "
         f"twice): coordinates and frameshift counts equal, scores within "
         f"{GENEWISE_SCORE_TOL} (max {err:.2e}); {ms:.2f} ms a call (the copies to the card "
         f"included), {launches} kernel launches a call")


# ------------------------------------------------------- Viterbi kernels
F32_OPS_PER_MS = 67e9  # H100 SXM float32 outside the tensor cores, 67 TFLOP/s
# operations a cell (model column x window position), counted from
# ops/phmm.py's plain versions: the scores pass 7 for M (3 adds, 3 max, the
# emission), 4 for I, 2 for the closure's input, log2(W) max rounds, 1 for D
# and 1 for the running best; the scan pass 16 for M (adds, compares and the
# two payload selects a candidate), 7 for I, 2, 4 a closure round, 1 for D
# and 5 for the per-column best
VITERBI_OPS = {"viterbi_scores_multi": (15, 1), "viterbi_scan": (30, 4)}
# the shapes of the golden run's largest searches:
# (pass, models, model length, windows, window width)
VITERBI_SHAPES = (("viterbi_scores_multi", 22, 72, 512, 4096),
                  ("viterbi_scores_multi", 1, 950, 512, 4096),
                  ("viterbi_scores_multi", 1, 1100, 512, 4096),
                  ("viterbi_scan", 1, 1100, 64, 4096))


def _viterbi_args(name, call):
    """(profile, model lengths, windows, lengths, band) of a recorded call."""
    if name == "viterbi_scan":
        prof, seqs, lengths, model_len, *rest = call[:-1]
        lens = [model_len]
    else:
        prof, lens, seqs, lengths, *rest = call[:-1]
    band = rest[0] if rest else call[-1].get("delete_band", 16)
    return prof, [int(x) for x in lens], seqs, lengths, band


def _viterbi_bound(name, prof, lens, seqs, lengths, band) -> tuple:
    """(bound ms, bound_by, cells): the larger of the operations this call's
    data needs (the cells inside each model and each row's length) at the
    float32 rate and its inputs and outputs once at the memory rate."""
    from mitoflex_tpu_torch.ops import phmm

    Lp, T = prof.msc.shape[-2], seqs.shape[1]
    steps = int(lengths.to(torch.int64).clamp(0, T).sum())
    cells = steps * sum(min(max(L, 0), Lp) for L in lens)
    base, per_round = VITERBI_OPS[name]
    W = phmm.closure_window(band, scores=name != "viterbi_scan")
    rounds = max(W, 1).bit_length() - 1  # log2(W); the exact closure is not timed
    ops = cells * (base + per_round * rounds)
    out_bytes = (5 if name == "viterbi_scan" else len(lens)) * 4 * seqs.shape[0]
    mem_ms = _bound_ms(*prof[:-1], seqs, lengths) + out_bytes / HBM_BYTES_PER_MS
    op_ms = ops / F32_OPS_PER_MS
    return max(op_ms, mem_ms), ("operations" if op_ms >= mem_ms else "bytes"), cells


def _time_viterbi(name, prof, lens, seqs, lengths, band, repeats: int = 5) -> dict:
    """The kernel (median of CUDA-event-timed wrapper calls) and the plain
    loop (one call) on the same inputs: scores bit-equal, coordinates
    exact, or AssertionError."""
    from mitoflex_tpu_torch.ops import phmm

    if name == "viterbi_scan":
        def run(fn):
            return fn(prof, seqs, lengths, lens[0], band)
        kernel, plain = phmm.viterbi_scan, phmm.viterbi_scan_plain
    else:
        def run(fn):
            return (fn(prof, lens, seqs, lengths, band),)
        kernel, plain = phmm.viterbi_scores_multi, phmm.viterbi_scores_multi_plain
    ms = _cuda_ms(lambda: run(kernel), repeats)
    layout = _viterbi_layout(name, prof, lens, seqs, band)
    got = run(kernel)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = run(plain)
    end.record()
    end.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g.contiguous().view(torch.int32), w.contiguous().view(torch.int32)):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{list(seqs.shape)}, Lp {prof.msc.shape[-2]}")
    bound, by, cells = _viterbi_bound(name, prof, lens, seqs, lengths, band)
    return {"ms": ms, "plain_ms": start.elapsed_time(end), "bound_ms": bound,
            "bound_by": by, "cells": cells, "max_abs_err": 0.0, "layout": layout,
            "ns_step": ms * 1e6 / _longest_row(seqs, lengths),
            "shape": f"{len(lens)} x Lp {prof.msc.shape[-2]}, {seqs.shape[0]} x T "
                     f"{seqs.shape[1]}"}


def _viterbi_line(name, r) -> str:
    return (f"{name} at {r['shape']} ({r['cells']} cells), layout {r['layout']}: kernel "
            f"{r['ms']:.4f} ms, {r['ns_step']:.1f} ns a step, plain {r['plain_ms']:.1f} ms "
            f"({r['plain_ms'] / r['ms']:.0f}x), bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of it), bit-equal")


def _viterbi_layout(name, prof, lens, seqs, band) -> tuple:
    """The layout ``viterbi_config`` picks for a call on this card."""
    from mitoflex_tpu_torch.ops import phmm

    scan = name == "viterbi_scan"
    return tuple(phmm.viterbi_config(
        prof.msc.shape[-2], len(lens) * seqs.shape[0],
        phmm.closure_window(band, scores=not scan), scan,
        torch.cuda.get_device_properties(seqs.device).multi_processor_count))


def _longest_row(seqs, lengths) -> int:
    """Steps of the call's longest row: its time is that row's chain."""
    return max(1, int(lengths.to(torch.int64).clamp(0, seqs.shape[1]).max()))


def _viterbi_call_shape(name, c) -> dict:
    """A recorded call's shape: enough to replay its kernel time on seeded
    data (the time depends on the shape, the model lengths and the rows'
    lengths, not on the scores)."""
    prof, lens, seqs, lengths, band = _viterbi_args(name, c)
    return {"pass": name, "models": len(lens), "Lp": int(prof.msc.shape[-2]),
            "model_lens": lens, "B": int(seqs.shape[0]), "T": int(seqs.shape[1]),
            "band": int(band), "lengths": [int(x) for x in lengths.tolist()]}


def check_viterbi_kernels(dev, calls: dict, nhmmer_calls: list, seed: int,
                          out_dir: str) -> dict:
    """Phase 13: both Viterbi passes of csrc/viterbi.cu against their plain
    loops on the seeded cases at every layout the chooser can pick, at the
    golden run's largest call of each pass and at the shapes of
    VITERBI_SHAPES; every golden call replayed (shape, layout, ms, ns a
    step) and its shape written to ``out_dir/viterbi_golden_calls.json``
    (what ``scripts/torch_kernel_bench.py --viterbi-calls`` replays);
    findmitoscaf's ``nhmmer_search`` call of the golden run again, alone,
    with its eager launches counted; returns, per pass, the numbers of its
    largest golden call with the largest error seen."""
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.models import nhmmer
    from mitoflex_tpu_torch.models.hmm import profile_from_consensus
    from mitoflex_tpu_torch.ops import phmm
    from mitoflex_tpu_torch.testing import kernel_cases, synth

    from mitoflex_tpu_torch import kernels

    t0 = time.perf_counter()
    n, n_calls = kernel_cases.check_viterbi(dev)
    torch.cuda.synchronize()
    _log(f"Viterbi kernels on {n} seeded (case, band) pairs (bands "
         f"{kernel_cases.VITERBI_BANDS}; Lp 64 to 8192, L < Lp and L = Lp, model lengths "
         f"at stage and cluster-block edges, ties across them, 0.5-bit scores, one "
         f"window, rows of length 0 and of N), {n_calls} kernel calls at every layout "
         f"the chooser can pick: scores bit-equal, coordinates exact "
         f"({time.perf_counter() - t0:.2f} s)")
    lib = kernels.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for Lp in (64, 128, 256, 1024, 2048, 4096, 8192):
        for W, scan in ((0, True), (2, False), (16, False), (16, True), (128, True)):
            for cfg in phmm.viterbi_configs(Lp, W, scan, sms):
                want = phmm.kernel_smem_bytes(cfg, W, scan)
                got = lib.mfx_viterbi_smem_bytes(cfg.warps, cfg.rows, W, int(scan))
                if got != want:
                    raise AssertionError(f"shared memory of layout {tuple(cfg)} at window "
                                         f"{W}: the kernel's {got}, the chooser's {want}")
    with open(os.path.join(out_dir, "viterbi_golden_calls.json"), "w") as f:
        json.dump([_viterbi_call_shape(name, c) for name, recorded in calls.items()
                   for c in recorded], f)
    out = {}
    for name, recorded in calls.items():
        args = [_viterbi_args(name, c) for c in recorded]
        sized = [(_viterbi_bound(name, *a)[2], i) for i, a in enumerate(args)]
        total = sum(c for c, _ in sized)
        r = _time_viterbi(name, *args[max(sized)[1]])
        out[name] = r
        _log(f"golden run's largest {_viterbi_line(name, r)}; {len(recorded)} calls "
             f"in the run, {total} cells in all")
        def describe(c, ms, name=name):
            prof, lens, seqs, lengths, band = _viterbi_args(name, c)
            return (f"{len(lens)} x Lp {prof.msc.shape[-2]}, {seqs.shape[0]} x T "
                    f"{seqs.shape[1]}, layout {_viterbi_layout(name, prof, lens, seqs, band)}: "
                    f"{ms:.4f} ms, {ms * 1e6 / _longest_row(seqs, lengths):.1f} ns a step")

        r.update(_golden_replay(name, recorded, lambda c, fn=getattr(phmm, name):
                                fn(c[0], *c[1:-1], **c[-1]), describe))
    stage, contigs, profiles, a, k = next(c for c in nhmmer_calls
                                          if c[0] == "run_findmitoscaf")
    ms, launches = _wall_ms_and_launches(
        lambda: nhmmer.nhmmer_search(contigs, profiles, *a, **k))
    _log(f"findmitoscaf's nhmmer_search of the golden run alone ({len(profiles)} "
         f"profiles, {len(contigs)} contigs): {ms:.1f} ms, {launches} kernel launches "
         f"under torch.profiler")
    rng = np.random.default_rng(seed + 13)
    for name, Mn, L, B, T in VITERBI_SHAPES:
        cons = [synth.random_genome(rng, L) for _ in range(Mn)]
        profs = [phmm.stage_profile(profile_from_consensus(f"S{i}", c), device=dev)
                 for i, c in enumerate(cons)]
        seqs = rng.integers(0, 4, (B, T)).astype(np.int8)
        for b in range(0, B, 3):  # a planted copy in every third window
            at = int(rng.integers(0, T - L))
            seqs[b, at: at + L] = encoding.encode(cons[b % Mn])
        s = torch.from_numpy(seqs).to(dev)
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
        prof = profs[0] if name == "viterbi_scan" else phmm.stack_profiles(profs)
        _log("shape " + _viterbi_line(name, _time_viterbi(name, prof, [L] * Mn, s,
                                                            lengths, 16, repeats=3)))
    return out


# ------------------------------------------------- Smith-Waterman kernel
# operations a cell (query column x target position), counted from
# ops/sw.py's plain version: 14 float32 (the substitution lookup; E's two
# subtractions and compare; the fresh-start compare, the diagonal's clamp
# and add; H''s compare; F's two subtractions and compare, in the
# sequential form of the plain version's prefix max, whose log2(Lq)
# doubling rounds the recurrence does not need; H's compare and clamp; the
# best's compare) and 47 int32 (six path-field selects each for E, the
# diagonal, H', F, H and the per-column best, two for the best's position,
# eight increments and the match compare)
SW_OPS_PER_CELL = 61


def _sw_bound(q, ql, t, tl, sub, *_) -> tuple:
    """(bound ms, bound_by, cells): the larger of the operations this call's
    cells need (each row's query length x target length) at the float32
    rate and its inputs and outputs once at the memory rate."""
    Lq, Lt = q.shape[1], t.shape[1]
    cells = int((ql.to(torch.int64).clamp(0, Lq) * tl.to(torch.int64).clamp(0, Lt)).sum())
    op_ms = cells * SW_OPS_PER_CELL / F32_OPS_PER_MS
    mem_ms = _bound_ms(q, ql, t, tl, sub) + 9 * 4 * q.shape[0] / HBM_BYTES_PER_MS
    return max(op_ms, mem_ms), ("operations" if op_ms >= mem_ms else "bytes"), cells


def _dp_layout(kind: str, q, t, kw) -> tuple:
    """The layout a call of ``sw_align`` (kind "sw") or ``genewise_align``
    ("genewise") runs at: the forced ``_config``, else the chooser's pick."""
    from mitoflex_tpu_torch.ops import genewise, row_pipeline, sw

    if kw.get("_config") is not None:
        return row_pipeline.PipelineConfig(*kw["_config"])
    choose = sw.sw_config if kind == "sw" else genewise.genewise_config
    return choose(q.shape[1], t.shape[1])


def _dp_steps(cfg, ql, tl) -> int:
    """Stage steps on the call's longest chain (``PipelineConfig.steps``)."""
    return max([1] + [cfg.steps(a, b) for a, b in zip(ql.tolist(), tl.tolist())])


def _time_sw(args, kw, repeats: int = 5, plain: bool = True) -> dict:
    """The kernel (median of CUDA-event-timed wrapper calls) and, with
    ``plain``, the plain loop (one call) on the same card tensors, all nine
    fields bit-equal, or AssertionError; the layout and ns a step over the
    call's longest chain."""
    from mitoflex_tpu_torch.ops import sw

    q, ql, t, tl = args[:4]
    times = _cuda_times(lambda: sw.sw_align(*args, **kw), repeats)
    cfg = _dp_layout("sw", q, t, kw)
    out = {"ms": float(np.median(times)), "min_ms": min(times), "max_ms": max(times),
           "max_abs_err": 0.0, "library_ms": None, "layout": tuple(cfg),
           "shape": f"{q.shape[0]} pairs x Lq {q.shape[1]} x Lt {t.shape[1]}"}
    out["ns_step"] = out["ms"] * 1e6 / _dp_steps(cfg, ql.cpu(), tl.cpu())
    out["bound_ms"], out["bound_by"], out["cells"] = _sw_bound(*args)
    if plain:
        got = sw.sw_align(*args, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = sw.sw_align_plain(*args, **{k: v for k, v in kw.items() if k != "_config"})
        end.record()
        end.synchronize()
        out["plain_ms"] = start.elapsed_time(end)
        for field, g, w in zip(sw.SwHits._fields, got, want):
            if not torch.equal(g.contiguous().view(torch.int32),
                               w.contiguous().view(torch.int32)):
                raise AssertionError(f"sw_align {field} differs from its plain version at "
                                     f"{out['shape']}")
    return out


def _sw_line(r) -> str:
    plain = (f", plain {r['plain_ms']:.1f} ms ({r['plain_ms'] / r['ms']:.0f}x), bit-equal"
             if "plain_ms" in r else "")
    return (f"{r['shape']} ({r['cells']} cells), layout {r['layout']}: kernel median "
            f"{r['ms']:.4f} ms (min {r['min_ms']:.4f}, max {r['max_ms']:.4f}), "
            f"{r['ns_step']:.1f} ns a step{plain}, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.2f}% of it)")


# the real-size tblastn shape: 64 pairs (a batch of blast's _batched_sw) of
# 600-residue proteins (COX1 ~510, ND5 ~600) against 5,300-codon windows
SW_REAL_SHAPE = (64, 600, 5300)


def _real_tblastn(dev, seed: int) -> tuple:
    """Seeded pairs of SW_REAL_SHAPE, BLOSUM62 at 12/1: random proteins, and
    in every target but each fourth a mutated copy of its query."""
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.testing import kernel_cases

    B, Lq, Lt = SW_REAL_SHAPE
    rng = np.random.default_rng(seed)
    arrays = kernel_cases._sw_pairs(rng, [Lq] * B, [Lt] * B, codon.NUM_AA, codon.X_CODE)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (*arrays, codon.blosum62().astype(np.float32))) + (12.0, 1.0)


def _check_dp_smem() -> int:
    """The choosers' shared-memory formulas against the library's, at every
    layout they weigh over a range of widths; returns the layouts held."""
    from mitoflex_tpu_torch import kernels
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.ops import genewise, sw

    lib = kernels.library()
    n = 0
    for Lq in (1, 100, 257, 600, 16500, 65600):
        for Lt in (0, 300, 5300):
            for cfgs, K, fn, mine in (
                    (sw.sw_configs(Lq, Lt), 5, lib.mfx_sw_smem_bytes, sw.sw_smem_bytes),
                    (genewise.genewise_configs(Lq, Lt), codon.NUM_AA,
                     lib.mfx_genewise_smem_bytes, genewise.genewise_smem_bytes)):
                for cfg in cfgs:
                    got = fn(K, cfg.warps, int(cfg.wide), cfg.rows)
                    if got != mine(cfg, K):
                        raise AssertionError(f"shared memory of layout {tuple(cfg)}: the "
                                             f"kernel's {got}, the chooser's {mine(cfg, K)}")
                    n += 1
    return n


def check_sw_kernel(dev, calls: list, seed: int) -> dict:
    """Phase 14: the Smith-Waterman kernel of csrc/sw.cu against its plain
    loop on every case of ``kernel_cases.sw_cases`` (the blastn-size and
    over-the-packing-limit ones included) at every layout the chooser
    weighs, the wide instantiation and a wrapping layout; the score kernel
    of csrc/sw_score.cu on every ``kernel_cases.sw_score_cases`` case
    against its plain version; each case timed
    beside its bound (the plain loop too at the card-size cases), the
    real-size tblastn shape and the golden run's largest call beside the
    plain loop (one wrapper call of it must make exactly one launch); the
    golden run's every call through the kernel once more, timed and summed;
    returns the numbers of the golden run's largest call with the sum."""
    from mitoflex_tpu_torch.ops import sw
    from mitoflex_tpu_torch.testing import kernel_cases

    t0 = time.perf_counter()
    n, n_calls = kernel_cases.check_sw(dev)
    torch.cuda.synchronize()
    _log(f"SW kernel on {n} seeded cases (BLOSUM62 at 12/1, DNA at 7/2, 11/1 and 3/3, Lq 1 "
         f"to 257 around the lanes and strips, empty, all-N/X and odd-code rows, tied best "
         f"cells, Lq {kernel_cases.SW_LONG_LQ} past 2^15, the blastn size, Lq "
         f"{kernel_cases.SW_WIDE_LQ} over the packing limit), {n_calls} kernel calls at "
         f"every layout the chooser weighs, the wide instantiation and a wrapping "
         f"layout: all nine fields bit-equal to the plain loop "
         f"({time.perf_counter() - t0:.2f} s); {_check_dp_smem()} layouts' shared "
         f"memory equal to the library's")
    t0 = time.perf_counter()
    n, pairs = kernel_cases.check_sw_scores(dev)
    _log(f"SW score kernel (csrc/sw_score.cu) on {n} seeded cases, {pairs} pairs (the SW "
         f"cases, both orientations, sides past one and two tiles, the merge's shape and "
         f"the int32 extremes): scores bit-equal to sw_scores_plain "
         f"({time.perf_counter() - t0:.2f} s)")
    for case in kernel_cases.sw_cases():
        args, go, ge = kernel_cases.sw_tensors(case, dev)
        big = case[1].shape[1] >= kernel_cases.SW_BLASTN_LQ
        r = _time_sw(args + (go, ge), {}, repeats=3, plain=big)
        _log(f"SW case {case[0]!r}: {_sw_line(r)}")
    r = _time_sw(_real_tblastn(dev, seed + 14), {})
    _log(f"SW real-size tblastn: {_sw_line(r)}")
    if not calls:
        raise AssertionError("the golden run made no sw_align call")
    sized = [(_sw_bound(*c[:-1])[2], i) for i, c in enumerate(calls)]
    largest = calls[max(sized)[1]]
    r = _time_sw(largest[:-1], largest[-1])
    ms, launches = _wall_ms_and_launches(lambda: sw.sw_align(*largest[:-1], **largest[-1]))
    if launches != 1:
        raise AssertionError(f"golden sw_align call: {launches} kernel launches in one "
                             f"wrapper call, not 1")
    _log(f"golden run's largest sw_align call: {_sw_line(r)}; {len(calls)} calls in the "
         f"run, {sum(c for c, _ in sized)} cells in all; one wrapper call {ms:.3f} ms on "
         f"the host clock (ending in a synchronise), {launches} kernel launch")
    r.update(_golden_replay("sw_align", calls, lambda c: sw.sw_align(*c[:-1], **c[-1])))
    return r


# ------------------------------------------------------ banded CYK kernel
# float32 operations a cell, counted from ops/cyk_device.py's plain
# version: a child 2 (the add and the max), the local end 4 (a compare, the
# multiply, the add and the max), an emission 1, a self-loop 4 (its step,
# its prefix sum, the add or subtract on each side of the cummax's max),
# the validity clamp and the block's max and argmax 3; a bifurcation 2 a
# term of its W-term max-plus sum
def _cyk_bound(x) -> tuple:
    """(bound ms, bound_by) of one call of the kernel on ``x``
    (``ops.cyk_device.KernelInputs``): the larger of the bytes the call must
    move (its inputs, its outputs and every W x W block written once, 4 W^2
    bytes each, at the memory rate; a child block is read soon after it is
    written, from the L2, and is not counted) and the float32 operations its
    states need at the float32 rate."""
    from mitoflex_tpu_torch.ops import cyk_device as cd

    table = x.step_table.cpu().numpy()
    W2 = x.W * x.W
    kind, flags = table[:, cd._W_KIND], table[:, cd._W_FLAGS]
    reg = kind >= 0
    per_cell = (2 * table[reg, cd._W_NKIDS] + 3 + (kind[reg] > 0)
                + 4 * ((flags[reg] & cd.HAS_END) != 0) + 4 * ((flags[reg] & cd.HAS_SELF) != 0))
    ops = W2 * (int(per_cell.sum()) + 3 * (int((~reg).sum()) + x.e_states.numel())) \
        + 2 * x.W * W2 * int((~reg).sum())
    byts = 4 * W2 * x.n_states + sum(
        t.numel() * t.element_size() for t in (x.step_table, x.e_states, x.single5, x.pair5,
                                               x.geo)) + 8 * x.n_states
    mem_ms, op_ms = byts / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return max(mem_ms, op_ms), ("bytes" if mem_ms >= op_ms else "operations")


def _time_cyk(args, dev, repeats: int = 5) -> dict:
    """The kernel (median of CUDA-event-timed calls of ``cyk_banded_device``
    after a warm-up) and the plain loop on the same card (one call), with
    the bound of the call."""
    from mitoflex_tpu_torch.ops import cyk_device as cd

    model, window, anchor, slack, local = args
    ms = _cuda_ms(lambda: cd.cyk_banded_device(model, window, anchor, slack, local, dev),
                  repeats)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    cd.cyk_banded_plain(model, window, anchor, slack, local, dev)
    end.record()
    end.synchronize()
    x = cd.kernel_inputs(model, window, anchor, slack, local, dev)
    bound, by = _cyk_bound(x)
    return {"ms": ms, "plain_ms": start.elapsed_time(end), "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "shape": f"{model.n_states} states, W {x.W}, L {x.L}, "
                     f"{'local' if local else 'glocal'}"}


def _cyk_line(r) -> str:
    return (f"{r['shape']}: kernel {r['ms']:.3f} ms, plain on the card "
            f"{r['plain_ms']:.1f} ms ({r['plain_ms'] / r['ms']:.0f}x), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({100 * r['bound_ms'] / r['ms']:.2f}% of it)")


def _hold_cyk(args, dev, what: str) -> tuple:
    """One call through the kernel, held against the plain version on the
    CPU (maxima, argmax cells and origins; maxima bit for bit or not) and on
    the same card (maxima; the card's plain loop sums its prefixes in another
    order, so a near tie may put its argmax elsewhere), and the picks of
    both: coordinates exact, scores within the tolerance. Returns (largest
    error, bit-equal to the CPU, the kernel's alignment)."""
    from mitoflex_tpu_torch.ops import cyk_device as cd
    from mitoflex_tpu_torch.testing import kernel_cases

    got = cd.cyk_banded_maxima(*args, dev)
    cpu = cd.cyk_banded_maxima_plain(*args, "cpu")
    card = cd.cyk_banded_maxima_plain(*args, dev)
    err = kernel_cases.check_cyk(got, cpu, f"{what}: kernel against the CPU")
    err = max(err, kernel_cases.check_cyk(got, card, f"{what}: kernel against the card's "
                                                     f"plain loop", cells=False))
    bit = bool(np.array_equal(got.m.view(np.int32), cpu.m.view(np.int32)))
    aln = cd.cyk_banded_device(*args, dev)
    for other, where in ((cd.cyk_banded_plain(*args, "cpu"), "the CPU"),
                         (cd.cyk_banded_plain(*args, dev), "the card's plain loop")):
        err = max(err, kernel_cases.check_cyk(aln, other, f"{what}: pick against {where}"))
    return err, bit, aln


def check_cyk_kernel(dev, calls: list) -> dict:
    """Phase 15: the banded CYK kernel of csrc/cyk.cu on every case of
    ``kernel_cases.cyk_cases`` (the CLEN-950 ones included) and on the
    golden run's calls, held against its plain loop on the card and on the
    CPU, with the host-banded <= kernel <= exact contract; each golden call
    and a case of each model timed beside the plain loop and the bound, the
    golden models' schedule depth printed; a tRNA-size call must make one
    kernel launch; returns the numbers of the golden run's largest call and
    the sum of its calls."""
    from mitoflex_tpu_torch.ops import cyk, cyk_device as cd
    from mitoflex_tpu_torch.testing import kernel_cases

    t0 = time.perf_counter()
    worst, n_bit, cases, timed = 0.0, 0, list(kernel_cases.cyk_cases()), {}
    for c in cases:
        model = kernel_cases.cyk_model(c.model_key)
        args = (model, c.window, c.anchor, c.slack, c.local)
        err, bit, aln = _hold_cyk(args, dev, c.name)
        worst, n_bit = max(worst, err), n_bit + bit
        host = cyk.cyk_banded(*args[:4], local=c.local)
        if host is not None and (aln is None or host.score > aln.score
                                 + kernel_cases.CYK_SCORE_TOL):
            raise AssertionError(f"{c.name}: host banded {host.score} over the kernel's {aln}")
        exact = cyk.cyk_align(model, c.window, local=c.local) \
            if c.model_key == "trna" and aln is not None else None
        # (the host's exact CYK finds no parse of the all-N window in local
        # mode, where the banded DP takes an EL end, as the JAX package's does)
        if exact is not None:
            if aln.score > exact.score + kernel_cases.CYK_SCORE_TOL or (
                    "planted" in c.name and abs(aln.score - exact.score)
                    > kernel_cases.CYK_SCORE_TOL):
                raise AssertionError(f"{c.name}: kernel {aln.score} against exact "
                                     f"{exact.score}")
        # the planted consensus at its place; of two planted copies the first
        first = c.anchor[:2] if "planted" in c.name else \
            (c.anchor[0] - model.clen // 2, c.anchor[1] - model.clen // 2)
        if ("planted" in c.name or "twice" in c.name) and (
                aln is None or (aln.seq_from, aln.seq_to) != first):
            raise AssertionError(f"{c.name}: consensus found at {aln}, planted at {first}")
        if "mutated" in c.name and c.local:
            timed.setdefault(c.model_key, args)
    _log(f"CYK kernel on {len(cases)} seeded cases (tRNA size at slack 8, 12, 48; CLEN 180 "
         f"and 950; glocal and local; planted, mutated, twice, N residues, truncated, "
         f"shorter than W, junk, all N): coordinates and argmax cells equal to the plain "
         f"loop on the CPU, maxima bit-equal to it in {n_bit} of {len(cases)} cases, picks "
         f"equal to the plain loop on the card, largest score error {worst:.2e} bits; host "
         f"banded <= kernel <= exact CYK at the tRNA size ({time.perf_counter() - t0:.2f} s)")
    for key, args in timed.items():
        _log(f"CYK case {key}: {_cyk_line(_time_cyk(args, dev, repeats=3))}")
    trna = timed["trna"]
    ms, launches = _wall_ms_and_launches(lambda: cd.cyk_banded_device(*trna, dev))
    plain_ms, plain_launches = _wall_ms_and_launches(lambda: cd.cyk_banded_plain(*trna, dev))
    _log(f"CYK tRNA-size call alone: {ms:.2f} ms on the host clock, {launches} kernel "
         f"launches under torch.profiler (the plain loop on the card: {plain_ms:.1f} ms, "
         f"{plain_launches} launches)")
    if launches != 1:
        raise AssertionError(f"a tRNA-size cyk_banded_device call made {launches} kernel "
                             f"launches, not 1")
    if not calls:
        raise AssertionError("the golden run made no cyk_banded_device call")
    out, worst, n_bit = None, 0.0, 0
    for i, args in enumerate(calls):
        err, bit, aln = _hold_cyk(args, dev, f"golden call {i}")
        worst, n_bit = max(worst, err), n_bit + bit
        r = _time_cyk(args, dev)
        x = cd.kernel_inputs(*args, dev)
        _log(f"golden run's cyk_banded_device call {i} ({args[0].name}, score "
             f"{aln.score:.3f}, window {aln.seq_from}..{aln.seq_to}): {_cyk_line(r)}; "
             f"maxima bit-equal to the CPU's: {bit}; schedule depth {x.depth} of "
             f"{x.n_states} states")
        if out is None or args[0].n_states > out["states"]:
            out = dict(r, states=args[0].n_states)
    out["max_abs_err"] = worst
    _log(f"golden run's {len(calls)} CYK calls: coordinates and argmax cells equal to the "
         f"CPU's, {n_bit} of {len(calls)} bit-equal, largest score error {worst:.2e} bits")
    out.update(_golden_replay("cyk_banded_device", calls,
                              lambda c: cd.cyk_banded_device(*c, dev)))
    if out["replay_launches"] != len(calls):
        raise AssertionError(f"{len(calls)} golden cyk_banded_device calls made "
                             f"{out['replay_launches']} kernel launches")
    return out


# -------------------------------------------------------- genewise kernel
# operations a cell (query column x target base), counted from
# ops/genewise.py's plain version: the score 4 (the gather, the stop
# compare and select, the validity select); each of the five H candidates
# 8 (the <= 0 compare and select, the penalty's subtraction, the compare
# with the running best, its select and three path-field selects), and 1
# more for the frameshift increment of four of them; the E candidate 5; E
# 7 (two subtractions, the compare, the value's and three fields' selects);
# Hc 1; F 12 in the sequential form of the plain version's prefix max (two
# subtractions, the compare, four selects; the compare with Hc and its four
# selects), whose log2(Lq) doubling rounds the recurrence does not need;
# the NEG clamp and the validity select 2; the per-column best 6 (the
# compare, the value's, three fields' and the base's selects)
GENEWISE_OPS_PER_CELL = 81
GENEWISE_REPEATS = 7


def _genewise_bound(q, ql, aa, tl, sub) -> tuple:
    """(bound ms, bound_by, cells): the larger of the operations this call's
    cells need (each hit's query length x target length) at the float32
    rate and its inputs and outputs once at the memory rate."""
    Lq, T = q.shape[1], aa.shape[1]
    cells = int((ql.to(torch.int64).clamp(0, Lq) * tl.to(torch.int64).clamp(0, T)).sum())
    op_ms = cells * GENEWISE_OPS_PER_CELL / F32_OPS_PER_MS
    k2 = sub.numel() if isinstance(sub, torch.Tensor) else np.asarray(sub).size
    mem_ms = _bound_ms(q, ql, aa, tl) + (4 * k2 + 6 * 4 * q.shape[0]) / HBM_BYTES_PER_MS
    return max(op_ms, mem_ms), ("operations" if op_ms >= mem_ms else "bytes"), cells


def _time_genewise(args, kw) -> dict:
    """The kernel (median and spread of GENEWISE_REPEATS CUDA-event-timed
    wrapper calls after a warm-up) and the plain loop (one call) on the same
    card tensors; all six fields bit-equal to the plain loop on the card and
    on the CPU, or AssertionError; the layout and ns a step over the call's
    longest chain."""
    from mitoflex_tpu_torch.ops import genewise

    times = _cuda_times(lambda: genewise.genewise_align(*args, **kw), GENEWISE_REPEATS)
    got = genewise.genewise_align(*args, **kw)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    card = genewise.genewise_align_plain(*args, **kw)
    end.record()
    end.synchronize()
    cpu = genewise.genewise_align_plain(
        *(x.cpu() if isinstance(x, torch.Tensor) else x for x in args), **kw)
    q, ql, aa, tl = args[:4]
    shape = f"{q.shape[0]} hits x Lq {q.shape[1]} x T {aa.shape[1]}"
    for where, want in (("the card", card), ("the CPU", cpu)):
        for field, g, w in zip(genewise.WiseHits._fields, got, want):
            if not torch.equal(g.contiguous().view(torch.int32).cpu(),
                               w.contiguous().view(torch.int32).cpu()):
                raise AssertionError(f"genewise_align {field} differs from the plain loop "
                                     f"on {where} at {shape}")
    cfg = _dp_layout("genewise", q, aa, kw)
    out = {"ms": float(np.median(times)), "min_ms": min(times), "max_ms": max(times),
           "plain_ms": start.elapsed_time(end), "max_abs_err": 0.0, "library_ms": None,
           "shape": shape, "layout": tuple(cfg)}
    out["ns_step"] = out["ms"] * 1e6 / _dp_steps(cfg, ql.cpu(), tl.cpu())
    out["bound_ms"], out["bound_by"], out["cells"] = _genewise_bound(*args[:5])
    return out


def _genewise_line(r) -> str:
    return (f"{r['shape']} ({r['cells']} cells), layout {r['layout']}: kernel median "
            f"{r['ms']:.4f} ms (min {r['min_ms']:.4f}, max {r['max_ms']:.4f}, "
            f"{GENEWISE_REPEATS} calls), {r['ns_step']:.1f} ns a step, plain loop on the card "
            f"{r['plain_ms']:.1f} ms ({r['plain_ms'] / r['ms']:.0f}x), bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({100 * r['bound_ms'] / r['ms']:.2f}% of it); all six fields bit-equal to "
            f"the plain loop on the card and on the CPU")


def check_genewise_kernel(dev, calls: list) -> dict:
    """Phase 16: the genewise kernel of csrc/genewise.cu on every case of
    ``kernel_cases.genewise_cases`` and on the golden run's calls, bit for
    bit against its plain loop on the card and on the CPU; the real-size
    case and each golden call timed beside the plain loop and the bound,
    and one wrapper call of each golden call must make one kernel launch;
    returns the numbers of the golden run's largest call and the sum of its
    calls."""
    from mitoflex_tpu_torch.ops import genewise
    from mitoflex_tpu_torch.testing import kernel_cases

    t0 = time.perf_counter()
    n, n_calls = kernel_cases.check_genewise(dev)
    torch.cuda.synchronize()
    _log(f"genewise kernel on {n} seeded cases (frameshifts of every step, stops, N codons "
         f"at 13/3/15/20 and 10/2/8/12, a gene planted twice, lengths 0 to 2, odd codes, "
         f"Lq 1 to 257 around the lanes and strips, 600 aa x 2000 bases, Lq "
         f"{kernel_cases.GENEWISE_LONG_LQ} past 2^15, Lq {kernel_cases.GENEWISE_WIDE_LQ} "
         f"over the packing limit), {n_calls} kernel calls at every layout the chooser "
         f"weighs, the wide instantiation and a wrapping layout: all six fields bit-equal "
         f"to the plain loop on the card and on the CPU ({time.perf_counter() - t0:.2f} s)")
    for case in kernel_cases.genewise_cases():
        if "real size" in case.name:
            r = _time_genewise(kernel_cases.genewise_tensors(case, dev) + case.penalties, {})
            _log(f"genewise case {case.name!r}: {_genewise_line(r)}")
    if not calls:
        raise AssertionError("the golden run made no genewise_align call")
    out = None
    for i, (args, kw) in enumerate(calls):
        r = _time_genewise(args, kw)
        ms, launches = _wall_ms_and_launches(lambda: genewise.genewise_align(*args, **kw))
        if launches != 1:
            raise AssertionError(f"golden genewise call {i}: {launches} kernel launches "
                                 f"in one wrapper call, not 1")
        _log(f"golden run's genewise_align call {i}: {_genewise_line(r)}; one wrapper call "
             f"{ms:.3f} ms on the host clock (ending in a synchronise), {launches} "
             f"kernel launch")
        if out is None or r["cells"] > out["cells"]:
            out = r
    out.update(_golden_replay("genewise_align", calls,
                              lambda c: genewise.genewise_align(*c[0], **c[1])))
    return out


# ----------------------------------------------------------- device mesh
MESH_GOLDEN_SHARDS = 4
MESH_SMALL_SHARDS = 2
MESH_SCORE_TOL = 1e-4   # tests/test_torch_{phmm,sw,genewise}.py


def _synced_s(fn, *a, **k):
    """(result, seconds on the host clock up to a synchronise)."""
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _zeroed_counters():
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _same_bytes(a: str, b: str, what: str) -> None:
    if _read_bytes(a) != _read_bytes(b):
        raise AssertionError(f"mesh: {what} differs from the single-device run's")


def run_mesh_golden(tmp: str, golden: dict, dev) -> dict:
    """Phase 12, golden volume: filter and assemble of phase 6's reads over
    a mesh of MESH_GOLDEN_SHARDS shards of one card; returns the launches."""
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.parallel import mesh as mesh_mod

    cfg = _slice_config(tmp, "golden_mesh", True, golden["fake"])
    ctx = pipeline.PipelineContext.create(cfg, device=dev)
    ctx.mesh = mesh_mod.make_mesh(devices=[dev] * MESH_GOLDEN_SHARDS)
    counters = _zeroed_counters()
    res, filter_s = _synced_s(pipeline.run_filter, ctx, golden["f1"], golden["f2"])
    assembled, assemble_s = _synced_s(pipeline.run_assemble, ctx, res.clean1, res.clean2,
                                      inputs_sharded=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    _same_bytes(res.clean1, golden["clean1"], "golden clean.1.fq")
    _same_bytes(res.clean2, golden["clean2"], "golden clean.2.fq")
    _same_bytes(ctx.workdir.stage_file("assemble", "contigs.fa"), golden["contigs"],
                "golden contigs.fa")
    _same_bytes(assembled, golden["assembled"], f"golden {os.path.basename(assembled)}")
    if ctx.device.type == "cuda" and min(_sort_launches(launches).values()) <= 0:
        raise AssertionError(f"mesh golden: a kernel of the path never launched: {launches}")
    _log(f"mesh golden volume ({MESH_GOLDEN_SHARDS} shards of {dev}): clean.1.fq, "
         f"clean.2.fq, contigs.fa and {os.path.basename(assembled)} byte-identical to "
         f"phase 6's; filter {filter_s:.3f} s (one device {golden['filter_s']:.3f} s), "
         f"assemble {assemble_s:.3f} s (one device {golden['assemble_s']:.3f} s; "
         f"sharded counting and graph pass); kernel launches {json.dumps(launches)}")
    return launches


def _stage_wall(out: str, fn: str) -> float:
    """A stage's wall from the last ``Leaving ... after Xs`` line of a run's
    log (findmitoscaf's own check calls it again inside)."""
    tag = f"Leaving mitoflex_tpu_torch.stages.{fn} after "
    lines = [ln for ln in out.splitlines() if tag in ln]
    if not lines:
        raise AssertionError(f"no {tag!r} line in the run's log")
    return float(lines[-1].split(tag)[1].rstrip("s"))


def run_mesh_small(tmp: str, fake, runs, dev) -> dict:
    """Phase 12, small read set: findmitoscaf and annotate of phase 8's card
    contigs over a mesh of MESH_SMALL_SHARDS shards of one card."""
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.parallel import mesh as mesh_mod

    stage = runs.stage
    contigs = json.loads(_read_bytes(stage("card", "assemble", "manifest.json")))["outputs"][0]
    cfg = _slice_config(os.path.join(tmp, "mesh_small"), "cli", False, fake)
    ctx = pipeline.PipelineContext.create(cfg, device=dev)
    ctx.mesh = mesh_mod.make_mesh(devices=[dev] * MESH_SMALL_SHARDS)
    counters = _zeroed_counters()
    found, find_s = _synced_s(pipeline.run_findmitoscaf, ctx, contigs)
    annotated, annotate_s = _synced_s(pipeline.run_annotate, ctx, found.path)
    launches = {name: fn.launches for name, fn in counters.items()}
    _same_bytes(found.path, stage("card", "findmitoscaf", "cli.picked.fa"),
                "small cli.picked.fa")
    _same_bytes(annotated.path, stage("card", "annotation", "locs.json"), "small locs.json")
    if min(launches[k] for k in ANNOTATE_KERNELS) <= 0:
        raise AssertionError(f"mesh small: a Viterbi, SW, CYK or genewise kernel never "
                             f"launched: {launches}")
    one_find = _stage_wall(runs.card_out, "findmitoscaf.findmitoscaf")
    one_ann = _stage_wall(runs.card_out, "annotate.annotate")
    _log(f"mesh small read set ({MESH_SMALL_SHARDS} shards of {dev}): picked FASTA and "
         f"locs.json byte-identical to phase 8's card run; findmitoscaf {find_s:.3f} s "
         f"(nhmmer {found.walls['nhmmer']:.3f} s; one device {one_find:.2f} s), annotate "
         f"{annotate_s:.3f} s (tblastn {annotated.walls['tblastn']:.3f} s, genewise "
         f"{annotated.walls['genewise']:.3f} s; one device {one_ann:.2f} s); kernel "
         f"launches {json.dumps(launches)}")
    return launches


def _equal_tensors(got, want, what: str) -> None:
    for name, g, w in zip(getattr(want, "_fields", range(len(want))), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} differs from the single-device call")


def check_mesh_functions(dev, fake) -> None:
    """Phase 12: each sharded function alone, on seeded inputs of shapes the
    path gives it, against its single-device counterpart on the same card."""
    from mitoflex_tpu_torch.io import encoding
    from mitoflex_tpu_torch.io.fasta import FastaRecord
    from mitoflex_tpu_torch.models import codon
    from mitoflex_tpu_torch.models.profiles import ProfileSet
    from mitoflex_tpu_torch.ops import filter as F
    from mitoflex_tpu_torch.convert import u32_numpy
    from mitoflex_tpu_torch.ops import genewise, kmer, mapper, phmm, spill, sw
    from mitoflex_tpu_torch.parallel import mesh as mesh_mod
    from mitoflex_tpu_torch.testing import synth

    mesh = mesh_mod.make_mesh(devices=[dev] * MESH_GOLDEN_SHARDS)
    rng = np.random.default_rng(29)
    walls = {}

    def both(name, sharded, single):
        got, walls[name + " mesh"] = _synced_s(sharded)
        want, walls[name] = _synced_s(single)
        return got, want

    # the filter at a golden batch that no shard count divides
    B, L = 8191, 160
    seqs = rng.integers(0, 5, (B, L)).astype(np.int8)
    quals = rng.integers(35, 75, (B, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    got, want = both("filter", lambda: mesh_mod.filter_reads_sharded(mesh, seqs, quals, lens),
                     lambda: F.filter_reads(*(torch.from_numpy(x).to(dev)
                                              for x in (seqs, quals, lens)), 10, 55, 0.2))
    _equal_tensors(got, want, "filter_reads_sharded")

    # partitioned counting (k = 31): half the keys have a first word >= 2**31
    reads = rng.integers(0, 4, (4096, 150)).astype(np.int8)
    rlens = np.full(4096, 150, np.int32)
    k = 31
    parts, walls["partitioned count mesh"] = _synced_s(
        mesh_mod.count_kmers_sharded_partitioned, mesh, reads, rlens, k)

    (keys, counts), walls["partitioned count"] = _synced_s(
        kmer.count_chunk_host, reads, rlens, k, canonical=False, device=dev)
    edges = [0, *spill.uniform_inner_boundaries(mesh.size).tolist(), 1 << 32]
    high = 0
    for j, (w, c, n) in enumerate(parts):
        first = w[0].to(torch.int64) & 0xFFFFFFFF
        if n and not (edges[j] <= int(first.min()) and int(first.max()) < edges[j + 1]):
            raise AssertionError(f"partitioned count: shard {j} holds keys outside its range")
        high += int((first >= 1 << 31).sum())
    if not np.array_equal(np.concatenate([u32_numpy(w).T for w, _, _ in parts]), keys) \
            or not np.array_equal(np.concatenate([c.cpu().numpy() for _, c, _ in parts]),
                                  counts.astype(np.int64)) or high == 0:
        raise AssertionError("count_kmers_sharded_partitioned differs from one device")

    # the mapper: golden-length reads against a two-contig index
    genome = fake.genome
    recs = [FastaRecord("c0", genome[: len(genome) // 2]),
            FastaRecord("c1", genome[len(genome) // 2:])]
    index = mapper.ContigIndex.build(recs, dev)
    mreads = [r for r, _ in synth.shotgun_reads(rng, genome, 8191, read_len=150,
                                                error_rate=0.01)]
    mseqs = np.full((len(mreads), 150), encoding.N, np.int8)
    for i, r in enumerate(mreads):
        mseqs[i, : len(r)] = encoding.encode(r)
    mlens = np.asarray([len(r) for r in mreads], np.int32)
    got, want = both(
        "mapper",
        lambda: mesh_mod.map_reads_sharded(mesh, index.keys, index.contig_of,
                                           index.pos_of, mseqs, mlens),
        lambda: mapper._map_device(index.keys, index.contig_of, index.pos_of,
                                   torch.from_numpy(mseqs).to(dev),
                                   torch.from_numpy(mlens).to(dev)))
    _equal_tensors(got, want, "map_reads_sharded")

    def close(got, want, what):
        for name, g, w in zip(want._fields, got, want):
            if name == "score":
                err = float((g - w).abs().max())
                if err > MESH_SCORE_TOL:
                    raise AssertionError(f"{what}: score error {err}")
            elif not torch.equal(g, w):
                raise AssertionError(f"{what}: {name} differs from the single-device call")

    # Smith-Waterman: 61 nucleotide pairs with planted mismatches
    counters = _zeroed_counters()
    q = rng.integers(0, 4, (61, 80)).astype(np.int8)
    t = q.copy()
    t[:, 10:14] = (t[:, 10:14] + 1) % 4
    ql = np.full(61, 80, np.int32)
    sub = sw.nucleotide_matrix()
    got, want = both("sw", lambda: mesh_mod.sw_align_sharded(mesh, q, ql, t, ql, sub, 5.0, 2.0),
                     lambda: sw.sw_align(*(torch.from_numpy(x).to(dev) for x in (q, ql, t, ql)),
                                         sub, 5.0, 2.0))
    close(got, want, "sw_align_sharded")

    # genewise: the seeded hits of phase 9
    _, batch = _genewise_batch()
    got, want = both("genewise",
                     lambda: mesh_mod.genewise_align_sharded(mesh, *batch, codon.blosum62()),
                     lambda: genewise.genewise_align(
                         *(torch.from_numpy(x).to(dev) for x in batch), codon.blosum62()))
    close(got, want, "genewise_align_sharded")

    # both Viterbi passes: the fixture's PCG models on windows of its genome
    hmms = ProfileSet(fake.profile_dir).cds_hmms(fake.clade)
    staged = [phmm.stage_profile(h, device=dev) for h in hmms]
    pad = max(p.msc.shape[0] for p in staged)
    stack = phmm.stack_profiles([phmm.stage_profile(h, pad_to=pad, device=dev) for h in hmms])
    both_strands = genome + encoding.revcomp_str(genome)
    starts = range(0, len(both_strands) - 512, 300)
    win = np.stack([encoding.encode(both_strands[s: s + 512]) for s in starts])
    wl = np.full(len(win), 512, np.int32)
    wl[::7] = 300
    model_lens = [h.length for h in hmms]
    got, want = both(
        "viterbi scores",
        lambda: mesh_mod.viterbi_scores_multi_sharded(mesh, stack, model_lens, win, wl),
        lambda: phmm.viterbi_scores_multi(stack, model_lens, torch.from_numpy(win).to(dev),
                                          torch.from_numpy(wl).to(dev)))
    err = float((got - want).abs().max())
    if err > MESH_SCORE_TOL:
        raise AssertionError(f"viterbi_scores_multi_sharded: score error {err}")
    got, want = both(
        "viterbi scan",
        lambda: mesh_mod.viterbi_scan_sharded(mesh, staged[0], win, wl, hmms[0].length),
        lambda: phmm.viterbi_scan(staged[0], torch.from_numpy(win).to(dev),
                                  torch.from_numpy(wl).to(dev), hmms[0].length))
    close(got, want, "viterbi_scan_sharded")
    vlaunches = {k: counters[k].launches for k in SEARCH_KERNELS + ("genewise_align",)}
    if min(vlaunches.values()) <= 0:
        raise AssertionError(f"mesh functions: a Viterbi, SW or genewise kernel never "
                             f"launched: {vlaunches}")
    _log(f"mesh functions alone ({MESH_GOLDEN_SHARDS} shards of {dev}) against one "
         f"device: filter {B} x {L} bit-equal; partitioned count of "
         f"{2 * reads.shape[0] * (reads.shape[1] - k + 1)} k-mers (k={k}, {high} keys with a first word >= 2**31) equal, each shard "
         f"within its key range; mapper {len(mreads)} x 150 equal; SW 61 pairs, genewise "
         f"{len(batch[0])} hits, Viterbi scores ({len(hmms)} models) and envelopes of "
         f"{len(win)} windows: coordinates equal, scores within {MESH_SCORE_TOL} (Viterbi, "
         f"SW and genewise kernel launches {json.dumps(vlaunches)}); walls, "
         f"s: " + ", ".join(f"{k_}: {v:.4f}" for k_, v in walls.items()))


def check_nccl_world1(tmp: str) -> None:
    """Phase 12: a process group of world size 1 on NCCL through
    ``init_distributed``, one all_reduce, torn down."""
    import torch.distributed as dist

    from mitoflex_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    got = distributed.init_distributed(
        backend="nccl", rank=0, world_size=1,
        init_method="file://" + os.path.join(tmp, "nccl_rendezvous"))
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        if got != (0, 1) or distributed.shard_info() != (0, 1) or not torch.equal(
                x.cpu(), torch.arange(8, dtype=torch.float32)):
            raise AssertionError(f"NCCL world 1: init {got}, all_reduce {x.tolist()}")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("NCCL world 1: the group is still up")
    _log(f"init_distributed: {backend} group of world size 1 through a file:// "
         f"rendezvous, all_reduce on the card, torn down "
         f"({time.perf_counter() - t0:.2f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out", default=None,
                    help="directory for the run's files (default: a temporary one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mitoflex_tpu_torch import kernels

    dev = torch.device("cuda")
    card = _nvidia_smi()
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from mitoflex_tpu_torch.native import fastq_native

    t0 = time.perf_counter()
    kernels.library()
    _log(f"kernel library {kernels.LIB_NAME} ready in "
         f"{time.perf_counter() - t0:.2f} s (nvcc {kernels.last_build_seconds:.2f} s, "
         f"{' '.join(kernels.ARCH_FLAGS)})")
    t0 = time.perf_counter()
    kernels.host_library()
    _log(f"native host library {fastq_native.LIB_NAME} ready in "
         f"{time.perf_counter() - t0:.2f} s (g++ "
         f"{fastq_native.last_build_seconds:.2f} s)")

    started = time.perf_counter()
    phase_s = {}

    def phase(name, fn, *a, **k):
        """Run one phase and keep its wall for the closing line."""
        t0 = time.perf_counter()
        out = fn(*a, **k)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0
        return out

    k1 = phase("2 K1", check_filter, dev)
    k2 = phase("3 K2", check_merge, dev)
    phase("3 K2", check_kernel_cases, dev)
    k3 = phase("4 K3", check_merge_onepass, dev)
    k4 = phase("5 K4", check_sort2, dev)
    tmp = args.out or tempfile.mkdtemp(prefix="mitoflex_chip_smoke_")
    os.makedirs(tmp, exist_ok=True)
    try:
        launches, passes, merges, golden = phase("6 golden all", run_golden_slice,
                                                 args.seed, tmp)
        k2_golden = phase("7 golden K2 K3", check_merge_golden, merges)
        k3_golden = phase("7 golden K2 K3", check_graph_pass_k3, passes)
        del passes, merges
        viterbi = phase("13 Viterbi", check_viterbi_kernels, dev,
                        golden.pop("viterbi_calls"), golden.pop("nhmmer_calls"),
                        args.seed, tmp)
        sw_golden = phase("14 SW", check_sw_kernel, dev, golden.pop("sw_calls"), args.seed)
        cyk_golden = phase("15 CYK", check_cyk_kernel, dev, golden.pop("cyk_calls"))
        gw_golden = phase("16 genewise", check_genewise_kernel, dev,
                          golden.pop("genewise_calls"))
        phase("12 mesh", run_mesh_golden, tmp, golden, dev)
        fake, f1, f2 = make_small_reads(args.seed, tmp)
        have_mpl = _have_matplotlib()
        runs = phase("8 small slice", run_small_all_vs_cpu, tmp, fake, f1, f2, have_mpl)
        phase("12 mesh", run_mesh_small, tmp, fake, runs, dev)
        phase("12 mesh", check_mesh_functions, dev, fake)
        phase("12 mesh", check_nccl_world1, tmp)
        phase("9 genewise", check_genewise_vs_cpu, dev)
        cpu_bim = phase("10 command line", run_command_line_rest, tmp, fake, f1, f2,
                        runs, have_mpl)
        try:
            phase("11 bim", run_bim_vs_cpu, tmp, fake, f1, f2, cpu_bim)
        finally:
            cpu_bim.kill()
    finally:
        if args.out is None:
            shutil.rmtree(tmp, ignore_errors=True)
    _log("phase walls, s: " + ", ".join(f"{k}: {v:.1f}" for k, v in phase_s.items())
         + f"; all phases {time.perf_counter() - started:.1f}")

    # each kernel's times and bound at a shape of the golden run: K1 at its
    # full-width batch, K2 at the LSM's largest merge, K3 at the first graph
    # pass's node step, K4 at one golden chunk
    k2_main = max(k2_golden, key=lambda r: r["na"] + r["nb"])
    k3_main, k4_main = k3_golden[0], k4[1]

    def entry(name, source, replaces, shape, errs):
        return {"name": name, "route": "cuda",
                "source": f"mitoflex_tpu_torch/csrc/{source}",
                "replaces": f"mitoflex_tpu/ops/{replaces}",
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in errs),
                "ms": shape["ms"], "plain_ms": shape["plain_ms"],
                "bound_ms": shape["bound_ms"], "bound_by": "bytes",
                "library_ms": shape.get("library_ms")}

    def golden_entry(name, source, replaces, r):
        """A scan kernel's entry: its golden run's largest call, with that
        run's launches and the sum of all of its calls."""
        return dict(entry(name, source, replaces, r, [r]), bound_by=r["bound_by"],
                    golden_launches=launches[name], golden_sum_ms=r["golden_sum_ms"])

    k1_entry = entry("filter_reads", "filter.cu", "filter.py:92", k1, [k1])
    k1_entry.update({k: k1[k] for k in ("raw_ms", "golden_ms", "golden_raw_ms",
                                        "golden_plain_ms", "golden_bound_ms")})
    kernels_line = {"kernels": [
        k1_entry,
        entry("merge_sorted_runs", "merge.cu", "psort.py:557", k2_main,
              k2 + k2_golden),
        entry("merge_sorted_runs_onepass", "merge.cu", "psort.py:467", k3_main,
              k3 + k3_golden),
        entry("sort_words2", "sort.cu", "psort.py:195", k4_main, k4),
        *(golden_entry(name, "viterbi.cu", replaces, viterbi[name])
          for name, replaces in (("viterbi_scores_multi", "phmm.py:352"),
                                 ("viterbi_scan", "phmm.py:140"))),
        golden_entry("sw_align", "sw.cu", "sw.py:60", sw_golden),
        dict(golden_entry("cyk_banded_device", "cyk.cu", "cyk_device.py:323", cyk_golden),
             name="cyk_banded"),
        golden_entry("genewise_align", "genewise.cu", "genewise.py:75", gw_golden),
    ]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
