"""Check and time the port's merge and sort kernels (K2, K3, K4) on one GPU.

    python3 scripts/torch_kernel_bench.py [--repo DIR] [--check] [--time]
                                          [--shapes FILE] [--label NAME]
                                          [--out FILE]

``--repo DIR`` imports ``mitoflex_tpu_torch`` from another checkout (for
example the parent commit unpacked by ``git archive``), so that two versions
can be timed in turns within one run on one card; only the public wrappers
of ``ops/psort.py`` are called, which both versions share.

``--check`` runs every case of ``mitoflex_tpu_torch.testing.kernel_cases``
through the kernels and holds the results against the plain versions
(exact; ``kernel_cases.check_wrappers``). ``--time`` prints one JSON line per shape: the kernel's median
milliseconds over CUDA-event-timed repeats after a warm-up (``ms``: one
wrapper call between two events, so it includes the wrapper's host time
before the launch), the time per call of 20 calls enqueued back to back
(``back_to_back_ms``), its bound (bytes
moved once at 3.35 TB/s) and, for the sort, ``torch.sort`` on the packed
key plus the gather. ``--shapes FILE`` adds K2 shapes from a JSON list of
``[na, nb, W]`` (the runs a pipeline run really merged). The card's name and
power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s


def cuda_ms(fn, repeats: int = 20) -> float:
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
    return float(np.median(times))


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


def time_shapes(psort, dev, label: str, extra_k2, out_path=None) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def emit(**row):
        row["label"] = label
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    k2 = [(1 << 21, 1 << 21, 2), (1 << 21, 1 << 21, 8), (1 << 25, 1 << 25, 2)]
    for na, nb, W in k2 + [tuple(s) for s in extra_k2]:
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
    for na, nb, W, P in k3:
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
    for n in (1 << 20, 8192 * 129, 16384 * 225, 1 << 24):
        words = torch.randint(-2**31, 2**31, (2, n), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        ms = cuda_ms(lambda: psort.sort_words2(words))
        lib_ms = cuda_ms(lambda: psort.sort_words2_ref(words))
        b2b = cuda_ms_back_to_back(lambda: psort.sort_words2(words))
        emit(kernel="K4", n=n, ms=ms, back_to_back_ms=b2b, library_ms=lib_ms,
             bound_ms=2 * 8 * n / HBM_BYTES_PER_MS)
        del words
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--shapes", default=None)
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
    if args.check:
        from mitoflex_tpu_torch.testing import kernel_cases

        print(f"check: {kernel_cases.check_wrappers(dev)} cases equal to the plain "
              f"versions", flush=True)
    if args.time:
        extra = []
        if args.shapes:
            with open(args.shapes) as f:
                extra = json.load(f)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        time_shapes(psort, dev, args.label, extra, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
