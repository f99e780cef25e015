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
4. The slice filter -> assemble at the golden-sample volume (a 16.5 kb
   circular genome at 400x plus two 8 kb nuclear decoys at 12x, 150 bp
   pairs, insert 300, 1% errors; tests/synth.py from --seed) through the
   port's PipelineContext(device="cuda"), run_filter and run_assemble.
   Both kernels' launch counters are zeroed just before and read just
   after; each must be > 0. A contig flagged circular must equal the
   planted genome up to rotation and strand once its (k-1)-base terminal
   duplication is dropped.
5. A small slice run on the card and on the CPU (the host formulations,
   held against the JAX package by tests/test_torch_slice.py): the clean
   FASTQs and the assembled FASTA must be byte-identical.

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


def _is_sorted(keys: torch.Tensor) -> bool:
    gt = torch.zeros(keys.shape[1] - 1, dtype=torch.bool, device=keys.device)
    eq = torch.ones_like(gt)
    for w in keys:
        a, b = w[:-1] ^ -(2**31), w[1:] ^ -(2**31)
        gt |= eq & (a > b)
        eq &= a == b
    return not bool(gt.any())


def _per_key_sums(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    new = torch.ones(keys.shape[1], dtype=torch.bool, device=keys.device)
    new[1:] = (keys[:, 1:] != keys[:, :-1]).any(0)
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    out = torch.zeros(int(new.sum()), dtype=torch.int64, device=keys.device)
    return out.index_add_(0, seg, vals.to(torch.int64) & 0xFFFFFFFF)


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


def _slice_config(tmp: str, workname: str, golden: bool):
    from mitoflex_tpu.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.run.basedir = tmp
    cfg.run.workname = workname
    cfg.search.disable_taxa = True
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


def run_golden_slice(seed: int, tmp: str) -> dict:
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.ops import filter as F
    from mitoflex_tpu_torch.ops import psort
    from tests import synth

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    genome = synth.random_genome(rng, 16500)
    decoys = [synth.random_genome(rng, 8000) for _ in range(2)]
    f1, f2, bases = _fastq_pair(rng, tmp, genome, decoys, cov=400, decoy_cov=12,
                                read_len=150, insert=300, error=0.01)
    _log(f"slice data: {bases} bases ({os.path.getsize(f1) * 2 >> 20} MiB FASTQ) "
         f"made in {time.perf_counter() - t0:.2f} s")
    cfg = _slice_config(tmp, "golden", golden=True)
    F.filter_reads.launches = 0
    psort.merge_sorted_runs.launches = 0
    ctx = pipeline.PipelineContext.create(cfg, device="cuda")
    t0 = time.perf_counter()
    res = pipeline.run_filter(ctx, f1, f2)
    torch.cuda.synchronize()
    filter_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = pipeline.run_assemble(ctx, res.clean1, res.clean2, inputs_sharded=True)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    launches = {"filter_reads": F.filter_reads.launches,
                "merge_sorted_runs": psort.merge_sorted_runs.launches}
    _log(f"slice walls: filter {filter_s:.3f} s ({res.reads_kept}/{res.reads_in} "
         f"pairs kept), assemble {assemble_s:.3f} s (incl. local extension and "
         f"scaffolding); kernel launches {json.dumps(launches)}; "
         f"peak device memory {torch.cuda.max_memory_allocated() >> 20} MiB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    hit = _planted_circle(out, genome, cfg.assemble.kmer_list)
    if not hit:
        raise AssertionError(f"no circular contig equals the planted genome in {out}")
    _log(f"slice output: contig {hit} is the planted {len(genome)} bp circle "
         f"(rotation/strand, after the terminal duplication)")
    return launches


def run_small_slice_vs_cpu(seed: int, tmp: str) -> None:
    from mitoflex_tpu_torch import pipeline
    from tests import synth

    rng = np.random.default_rng(seed + 1)
    genome = synth.random_genome(rng, 4000)
    decoys = [synth.random_genome(rng, 1500)]
    f1, f2, _ = _fastq_pair(rng, tmp, genome, decoys, cov=60, decoy_cov=20,
                            read_len=100, insert=300, error=0.005)
    outs, paths = {}, {}
    for dev in ("cuda", "cpu"):
        ctx = pipeline.PipelineContext.create(_slice_config(tmp, f"small_{dev}", False),
                                              device=dev)
        res = pipeline.run_filter(ctx, f1, f2)
        paths[dev] = pipeline.run_assemble(ctx, res.clean1, res.clean2)
        outs[dev] = []
        for p in (res.clean1, res.clean2, paths[dev]):
            with open(p, "rb") as f:
                outs[dev].append(f.read())
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("small slice: CUDA and CPU outputs differ")
    if not _planted_circle(paths["cuda"], genome, [21, 41]):
        raise AssertionError("small slice: planted circle not recovered")
    _log("small slice: clean FASTQs and assembly byte-identical on CUDA and CPU")


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
    tmp = args.out or tempfile.mkdtemp(prefix="mitoflex_chip_smoke_")
    os.makedirs(tmp, exist_ok=True)
    try:
        launches = run_golden_slice(args.seed, tmp)
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
    ]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
