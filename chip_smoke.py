"""Smoke run of the PyTorch port (mitoflex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 2026] [--out DIR]

Phases, each printing its own lines; any failure exits non-zero:

1. torch / CUDA versions and the card; build the CUDA kernel library from
   mitoflex_tpu_torch/csrc (timed).
2. K1, the read-filter kernel, against its plain PyTorch version at
   65536 x 256 (random reads plus edge rows): bit-equal; both timed.
3. K2, the sorted-run merge kernel, against its plain version at 2 x 2**21
   rows (W = 2 and W = 8 key words) and 2 x 2**25 rows (W = 2, the device
   LSM's cap): output sorted, keys exact, per-key payload sums equal; both
   timed.
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
6. The slice filter -> assemble -> findmitoscaf at the golden-sample
   volume: the synthetic profile set's genome (tests/profile_fixture.py,
   spacer 2440: a ~13.2 kb circle with four PCGs) at 400x plus two 8 kb
   nuclear decoys at 12x, 150 bp pairs, insert 300, 1% errors, from
   --seed, through the port's PipelineContext(device="cuda"), run_filter,
   run_assemble and run_findmitoscaf. All four kernels' launch counters are
   zeroed just before and read just after; each must be > 0. The picked
   FASTA must hold a circular scaffold equal to the planted genome up to
   rotation and strand once its (k-1)-base terminal duplication is
   dropped, and the manifest must list all four PCGs as found.
7. K3 again on the edge tables that the golden run's graph passes took
   (one per pass, k = 31 to 119, W = 2 to 8): row-for-row equal to its
   plain version; the node step (node table and endpoint ids) and the
   whole graph pass timed with K3 and with the sort-and-join formulation
   that K3 replaced.
8. A small slice through findmitoscaf run twice, on the card and on the
   CPU (the host formulations, held against the JAX package by
   tests/test_torch_slice.py): the clean FASTQs, the contigs and the picked
   FASTA must be byte-identical.

Kernel times are medians of CUDA-event-timed repeats after a warm-up. The
last two lines are one JSON object of per-kernel results and then
{"ok": true, "device": {...}}; the card's name and power limit (from
nvidia-smi) are printed before them. Without a CUDA device the script exits
non-zero before any result.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
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
    return float(np.median(times))


# ------------------------------------------------------------------ K1
def check_filter(dev) -> dict:
    from mitoflex_tpu.io import encoding
    from mitoflex_tpu_torch.ops import filter as F

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
        got = F.filter_reads(*t[:3], *args, cl)
        want = F.filter_reads_ref(*t[:3], *args, cl)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    keep = F.filter_reads(*t[:3], *args)[0][:6].tolist()
    if err != 0 or keep != [True, False, True, False, True, False]:
        raise AssertionError(f"K1 disagrees with filter_reads_ref: max err {err}, "
                             f"edge rows {keep}")
    ms = _cuda_ms(lambda: F.filter_reads(*t[:3], *args))
    plain_ms = _cuda_ms(lambda: F.filter_reads_ref(*t[:3], *args))
    _log(f"K1 filter_reads {B}x{L}: bit-equal to filter_reads_ref (SE and PE "
         f"cutoffs); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
         f"{B * L / ms / 1e6:.2f} Gbase/s")
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}


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


def check_merge(dev) -> list:
    from mitoflex_tpu_torch.ops import psort

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    results = []
    for log2m, W in ((21, 2), (21, 8), (25, 2)):
        m = 1 << log2m
        a = _random_run(gen, m, W, dev)
        b = _random_run(gen, m, W, dev)
        got = psort.merge_sorted_runs(*a, *b)
        want = psort.merge_sorted_runs_ref(*a, *b)
        torch.cuda.synchronize()
        if not _is_sorted(got[0]):
            raise AssertionError(f"K2 output not sorted (m=2^{log2m}, W={W})")
        key_err = int((got[0].to(torch.int64) - want[0].to(torch.int64)).abs().max())
        sum_err = int((_per_key_sums(*got) - _per_key_sums(*want)).abs().max())
        if key_err or sum_err:
            raise AssertionError(f"K2 disagrees with merge_sorted_runs_ref "
                                 f"(m=2^{log2m}, W={W}): key err {key_err}, "
                                 f"per-key sum err {sum_err}")
        del want
        ms = _cuda_ms(lambda: psort.merge_sorted_runs(*a, *b), repeats=10)
        plain_ms = _cuda_ms(lambda: psort.merge_sorted_runs_ref(*a, *b), repeats=10)
        _log(f"K2 merge_sorted_runs 2x2^{log2m} rows, W={W}: sorted, keys exact, "
             f"per-key sums equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"{2 * m / ms / 1e6:.2f} Grows/s")
        results.append({"max_abs_err": float(max(key_err, sum_err)), "ms": ms,
                        "plain_ms": plain_ms})
        del a, b, got
        torch.cuda.empty_cache()
    return results


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
        err = _k3_compare(runs, f"m=2^{log2m}, P={P}")
        ms = _cuda_ms(lambda: psort.merge_sorted_runs_onepass(*runs), repeats=10)
        plain_ms = _cuda_ms(lambda: psort.merge_sorted_runs_onepass_ref(*runs),
                            repeats=10)
        _log(f"K3 merge_sorted_runs_onepass 2x2^{log2m} rows, W=2, P={P}: row-for-row "
             f"equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"{2 * m / ms / 1e6:.2f} Grows/s")
        results.append({"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms})
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
        err = _k3_compare(runs, f"W={W}, P=1, {na} + {nb} rows")
        ms = _cuda_ms(lambda: psort.merge_sorted_runs_onepass(*runs), repeats=10)
        plain_ms = _cuda_ms(lambda: psort.merge_sorted_runs_onepass_ref(*runs),
                            repeats=10)
        _log(f"K3 merge_sorted_runs_onepass {na}+{nb} rows, W={W}, P=1 (prefix-like "
             f"run A with a {na // 8}-row tie block): row-for-row equal; kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        results.append({"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms})
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
        err = _k3_compare(_positions_runs(prefix, suffix, psort.lexsort_words(suffix)),
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
             f"row-for-row equal; node step {step_ms:.4f} ms with K3, "
             f"{step_sort_ms:.4f} ms with sort-and-join; graph pass {pass_ms:.4f} ms "
             f"with K3, {pass_sort_ms:.4f} ms with sort-and-join")
        results.append({"max_abs_err": float(err), "k": k, "W": W, "E": E,
                        "step_ms": step_ms, "step_sort_ms": step_sort_ms,
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
        _log(f"K4 sort_words2 n={n}: equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
             f"ms, {n / ms / 1e6:.2f} Gkeys/s")
        results.append({"n": n, "max_abs_err": float(err), "ms": ms,
                        "plain_ms": plain_ms})
        del words
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- slice
def _fastq_pair(rng, tmp: str, genome: str, decoys, cov: int, decoy_cov: int,
                read_len: int, insert: int, error: float):
    from tests import synth

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


def _planted_circle(fa_path: str, genome: str, klist) -> str:
    """The id of a contig flagged circular that is the genome up to rotation
    and strand after its (k-1)-base terminal duplication; '' if none."""
    from mitoflex_tpu.io import encoding, fasta

    doubled = genome + genome
    for rec in fasta.load_fasta(fa_path):
        if not rec.flag & 1:
            continue
        for k in klist:
            core = rec.seq[: len(rec.seq) - (k - 1)]
            if len(core) == len(genome) and (
                    core in doubled or encoding.revcomp_str(core) in doubled):
                return rec.id
    return ""


def _slice_config(tmp: str, workname: str, golden: bool, fake):
    from mitoflex_tpu.config import PipelineConfig

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


def _launch_counters():
    from mitoflex_tpu_torch.ops import filter as F
    from mitoflex_tpu_torch.ops import psort

    return {"filter_reads": F.filter_reads, "merge_sorted_runs": psort.merge_sorted_runs,
            "merge_sorted_runs_onepass": psort.merge_sorted_runs_onepass,
            "sort_words2": psort.sort_words2}


def run_golden_slice(seed: int, tmp: str):
    """Returns the launch counts and the graph passes' inputs
    ((edge_words, edge_counts, k) each, kept for phase 7)."""
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.ops import dbg
    from tests import profile_fixture, synth

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    fake = profile_fixture.build(pathlib.Path(tmp), rng, spacer=2440)
    genome = fake.genome
    decoys = [synth.random_genome(rng, 8000) for _ in range(2)]
    f1, f2, bases = _fastq_pair(rng, tmp, genome, decoys, cov=400, decoy_cov=12,
                                read_len=150, insert=300, error=0.01)
    _log(f"slice data: {len(genome)} bp genome with {len(profile_fixture.GENES)} PCGs, "
         f"{bases} bases ({os.path.getsize(f1) * 2 >> 20} MiB FASTQ) made in "
         f"{time.perf_counter() - t0:.2f} s")
    cfg = _slice_config(tmp, "golden", True, fake)
    passes = []
    graph_pass = dbg.graph_unitig_pass

    def kept_graph_pass(edge_words, edge_counts, k):
        passes.append((edge_words.clone(), edge_counts.clone(), k))
        return graph_pass(edge_words, edge_counts, k)

    counters = _launch_counters()
    ctx = pipeline.PipelineContext.create(cfg, device="cuda")
    dbg.graph_unitig_pass = kept_graph_pass
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = pipeline.run_filter(ctx, f1, f2)
        torch.cuda.synchronize()
        filter_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        contigs = pipeline.run_assemble(ctx, res.clean1, res.clean2,
                                        inputs_sharded=True)
        torch.cuda.synchronize()
        assemble_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        found = pipeline.run_findmitoscaf(ctx, contigs)
        torch.cuda.synchronize()
        find_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        dbg.graph_unitig_pass = graph_pass
    w = found.walls
    _log(f"slice walls: filter {filter_s:.3f} s ({res.reads_kept}/{res.reads_in} "
         f"pairs kept), assemble {assemble_s:.3f} s (incl. local extension and "
         f"scaffolding), findmitoscaf {find_s:.3f} s (nhmmer {w['nhmmer']:.3f} s, "
         f"blastn/tblastn with SW {w['blast']:.3f} s, rest "
         f"{find_s - w['nhmmer'] - w['blast']:.3f} s); kernel launches "
         f"{json.dumps(launches)}; peak device memory "
         f"{torch.cuda.max_memory_allocated() >> 20} MiB")
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
    _log(f"slice output: picked scaffold {hit} is the planted {len(genome)} bp circle "
         f"(rotation/strand, after the terminal duplication); PCGs found "
         f"{manifest['found_pcgs']}")
    return launches, passes


def run_small_slice_vs_cpu(seed: int, tmp: str) -> None:
    from mitoflex_tpu_torch import pipeline
    from tests import profile_fixture, synth

    rng = np.random.default_rng(seed + 1)
    fake = profile_fixture.build(pathlib.Path(tmp) / "small", rng, spacer=600)
    decoys = [synth.random_genome(rng, 1500)]
    f1, f2, _ = _fastq_pair(rng, tmp, fake.genome, decoys, cov=60, decoy_cov=20,
                            read_len=100, insert=300, error=0.005)
    outs, picked = {}, {}
    for run in ("cuda", "cpu"):
        ctx = pipeline.PipelineContext.create(
            _slice_config(tmp, f"small_{run}", False, fake), device=run)
        res = pipeline.run_filter(ctx, f1, f2)
        contigs = pipeline.run_assemble(ctx, res.clean1, res.clean2)
        picked[run] = pipeline.run_findmitoscaf(ctx, contigs).path
        outs[run] = []
        for p in (res.clean1, res.clean2, contigs, picked[run]):
            with open(p, "rb") as f:
                outs[run].append(f.read())
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("small slice: outputs differ between CUDA and CPU")
    if not _planted_circle(picked["cuda"], fake.genome, [21, 41]):
        raise AssertionError("small slice: planted circle not picked")
    _log("small slice: clean FASTQs, contigs and picked FASTA byte-identical on CUDA "
         "and CPU")


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
    t0 = time.perf_counter()
    kernels.library()
    _log(f"kernel library {kernels.LIB_NAME} ready in "
         f"{time.perf_counter() - t0:.2f} s (nvcc {kernels.last_build_seconds:.2f} s, "
         f"{' '.join(kernels.ARCH_FLAGS)})")

    k1 = check_filter(dev)
    k2 = check_merge(dev)
    k3 = check_merge_onepass(dev)
    k4 = check_sort2(dev)
    tmp = args.out or tempfile.mkdtemp(prefix="mitoflex_chip_smoke_")
    os.makedirs(tmp, exist_ok=True)
    try:
        launches, passes = run_golden_slice(args.seed, tmp)
        k3 += check_graph_pass_k3(passes)
        del passes
        run_small_slice_vs_cpu(args.seed, tmp)
    finally:
        if args.out is None:
            shutil.rmtree(tmp, ignore_errors=True)

    kernels_line = {"kernels": [
        {"name": "filter_reads", "route": "cuda",
         "source": "mitoflex_tpu_torch/csrc/filter.cu",
         "replaces": "mitoflex_tpu/ops/filter.py:92",
         "launches": launches["filter_reads"], **k1},
        {"name": "merge_sorted_runs", "route": "cuda",
         "source": "mitoflex_tpu_torch/csrc/merge.cu",
         "replaces": "mitoflex_tpu/ops/psort.py:557",
         "launches": launches["merge_sorted_runs"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": k2[0]["ms"], "plain_ms": k2[0]["plain_ms"]},
        {"name": "merge_sorted_runs_onepass", "route": "cuda",
         "source": "mitoflex_tpu_torch/csrc/merge.cu",
         "replaces": "mitoflex_tpu/ops/psort.py:467",
         "launches": launches["merge_sorted_runs_onepass"],
         "max_abs_err": max(r["max_abs_err"] for r in k3),
         "ms": k3[0]["ms"], "plain_ms": k3[0]["plain_ms"]},
        {"name": "sort_words2", "route": "cuda",
         "source": "mitoflex_tpu_torch/csrc/sort.cu",
         "replaces": "mitoflex_tpu/ops/psort.py:195",
         "launches": launches["sort_words2"],
         "max_abs_err": max(r["max_abs_err"] for r in k4),
         "ms": k4[1]["ms"], "plain_ms": k4[1]["plain_ms"]},
    ]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
