"""A traced sample: ``torch.profiler`` over it, and the trace reduced.

The profiler's Chrome trace gives the device's work (kernels, copies and
sets, each with the correlation id of the host call that launched it) and
the harness's ranges on the host (``mfx.sample``, ``mfx.stage.*``,
``mfx.op.*``). From them:

- ``busy_s``: the union of the device's intervals inside the sample's range;
  ``window_s``: the length of that range;
- each op call's device time: the work launched while its
  ``mfx.op.<op>#<call number>`` range was open;
- ``device_ops``: the device operations that took most time, by name;
- ``idle_gaps``: the longest gaps between device intervals, each named by
  the innermost harness range the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def trace_sample(sample, run, out_dir: str) -> dict:
    """Runs ``run(sample)`` under the profiler and reduces its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("mfx.sample"):
            run(sample)
        torch.cuda.synchronize()
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events: List[dict]) -> dict:
    """The reduction above from Chrome-trace events (times in us)."""
    device, launch_ts, ranges = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and str(e.get("name", "")).startswith("mfx."):
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
    sample = [r for r in ranges if r[2] == "mfx.sample"]
    if not sample:
        raise ValueError("the trace holds no mfx.sample range")
    w0, w1 = sample[0][0], sample[0][1]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in device]
    busy = _union([(max(a, w0), min(b, w1)) for a, b in spans if a < w1 and b > w0])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0))
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # op ranges do not nest: each device interval goes to the range open at
    # its launch
    op_ranges = sorted((a, b, n[len("mfx.op."):]) for a, b, n in ranges if n.startswith("mfx.op."))
    starts = [r[0] for r in op_ranges]
    op_us = [0.0] * len(op_ranges)
    for e in device:
        ts = launch_ts.get((e.get("args") or {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= op_ranges[i][1]:
            op_us[i] += float(e.get("dur", 0))
    op_device_ms: Dict[int, float] = {}
    for (a, b, name), us in zip(op_ranges, op_us):
        op_device_ms[int(name.rpartition("#")[2])] = us / 1e3

    edges = [(w0, w0)] + busy + [(w1, w1)]
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a),
                  reverse=True)[:TOP]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inner = [r for r in ranges if r[0] <= mid <= r[1]]
        label = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "harness"
        idle.append([label, length / 1e6])
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "op_device_ms": op_device_ms,
            "device_ops": [[n, us / 1e6] for n, us in device_ops],
            "idle_gaps": idle}
