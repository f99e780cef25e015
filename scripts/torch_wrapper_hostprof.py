"""Where a kernel wrapper's host time goes, on one GPU.

    python3 scripts/torch_wrapper_hostprof.py

At the graph pass's shapes the port's merge kernels run for about ten
microseconds, less than their Python wrapper spends before and around the
launch. This script times, on the host clock and per call, the one-pass
merge's wrapper at such a shape (W = 4 key words, 93,553 + 93,551 rows, one
payload word) and the parts it is made of: the two output allocations, the
tensor checks, the device guard with a stream object's handle, that handle
alone, the raw-stream query the wrappers use, the library handle, and the
raw ctypes launch with outputs allocated ahead; then the read filter's wrapper at its
golden batch shape (8192 x 160) and its parts. Each line gives microseconds per call to enqueue, and per call until
the device has finished (the second exceeds the first only where the device
is the slower side). The card's name and power limit are printed first.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mitoflex_tpu_torch import kernels  # noqa: E402
from mitoflex_tpu_torch.ops import psort  # noqa: E402


def host_us(fn, calls: int = 2000):
    """(microseconds per call to enqueue, microseconds per call until the
    device is idle again)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wrapper_hostprof: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    lib = kernels.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    W, na, nb = 4, 93_553, 93_551

    def run(n):
        k = torch.randint(-2**31, 2**31, (W, n), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        return k[:, psort.lexsort_words(k)].contiguous()

    a, b = run(na), run(nb)
    pa = torch.zeros((1, na), dtype=torch.int32, device=dev)
    pb = torch.zeros((1, nb), dtype=torch.int32, device=dev)

    def report(what, fn):
        enqueue, total = host_us(fn)
        print(f"{what}: {enqueue:.2f} us to enqueue, {total:.2f} us until done",
              flush=True)

    def outputs():
        return (torch.empty((W, na + nb), dtype=torch.int32, device=dev),
                torch.empty((1, na + nb), dtype=torch.int32, device=dev))

    def guard_and_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    report("merge_sorted_runs_onepass wrapper",
           lambda: psort.merge_sorted_runs_onepass(a, pa, b, pb))
    report("two torch.empty outputs", outputs)
    report("four tensor checks", lambda: [
        psort._check_words("probe", "x", t, t.shape[0], None, dev)
        for t in (a, pa, b, pb)])
    report("device guard and stream object's handle", guard_and_stream)
    report("stream object's handle alone",
           lambda: torch.cuda.current_stream(dev).cuda_stream)
    report("current device and raw-stream query (what kernels.launch does)",
           lambda: (torch.cuda.current_device(),
                    torch._C._cuda_getCurrentRawStream(dev.index)))
    report("library handle", kernels.library)
    out_keys, out_pays = outputs()
    args = (a.data_ptr(), pa.data_ptr(), na, b.data_ptr(), pb.data_ptr(), nb, W, 1,
            out_keys.data_ptr(), out_pays.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    report("raw ctypes launch, outputs allocated ahead",
           lambda: kernels.check(lib.mfx_merge_sorted_runs_onepass(*args), "probe"))

    # the read filter at the golden batch shape, where the kernel is shorter
    # than its wrapper's host time
    from mitoflex_tpu_torch.ops import filter as F

    B, L = 8192, 160
    seqs = torch.randint(0, 5, (B, L), generator=gen, device=dev).to(torch.int8)
    quals = torch.randint(35, 74, (B, L), generator=gen, device=dev).to(torch.int8)
    lens = torch.randint(1, L + 1, (B,), generator=gen, device=dev).to(torch.int32)
    report(f"filter_reads wrapper at {B} x {L}",
           lambda: F.filter_reads(seqs, quals, lens, 10, 55, 0.2))
    report("its two torch.empty outputs", lambda: (
        torch.empty(B, dtype=torch.bool, device=dev),
        torch.empty((2, B), dtype=torch.int32, device=dev)))
    keep = torch.empty(B, dtype=torch.bool, device=dev)
    hashes = torch.empty((2, B), dtype=torch.int32, device=dev)
    report("the two views of the hash tensor", lambda: hashes.unbind(0))
    report("launch_filter, outputs allocated ahead",
           lambda: F.launch_filter(seqs, quals, lens, lens, 10, 55, 0.2, keep, hashes))
    report("the plain version's quality_cutoffs (the four eager kernels the "
           "wrapper no longer runs)", lambda: F.quality_cutoffs(lens, 0.2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
