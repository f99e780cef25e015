"""Run one cell of the benchmark of ``mitoflex_tpu_torch`` on the card.

    python -m mfxbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over a window of whole samples; ``--trace 1`` traces one sample
with ``torch.profiler`` and reports the cell's per-layer metrics. Either
way the window's outputs are compared with the plain reference once it has
closed. Earlier lines say what set-up took, what the host did over the
window, the stage walls, the kernel launches a sample and the card; the
last line of standard output is the result, one JSON object, and the last
lines of standard error are the compared numbers beside their limits.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def process_age_s() -> float:
    """Seconds since this process started (Linux), 0.0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def host_usage() -> dict:
    """The wall clock and this process's CPU seconds."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(), "user_s": r.ru_utime, "sys_s": r.ru_stime}


def host_line(a: dict, b: dict) -> dict:
    """What the host did over a window: this process's CPU seconds against
    the wall (a wait for the card spins, and counts as CPU time)."""
    d = {k: b[k] - a[k] for k in a}
    d["cpu_share"] = (d["user_s"] + d["sys_s"]) / max(d["wall_s"], 1e-9)
    return d


def metric_specs(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` (end_to_end / per_layer) this cell reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end":
            out.append(m)
        else:
            moves = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            if "workloads" not in moves or cell in moves["workloads"]:
                out.append(m)
    return out


class Readings:
    """What the metric readers read: the window's totals, the set-up, the
    traced sample's spans, op calls and device times."""

    def __init__(self, cell, window_s: float, setup_s: float, trace: dict) -> None:
        done = [s for s in cell.done if not s.error]
        self.cell = cell.workload["name"]
        self.window_s = window_s
        self.setup_s = setup_s
        self.samples = len(done)
        self.bases = sum(s.bases for s in done)
        self.spans = cell.spans.spans
        self.busy_s = trace.get("busy_s")
        self.trace_window_s = trace.get("window_s")
        self.op_calls = {}
        self.untraced_calls = 0
        if trace:
            device = trace["op_device_ms"]
            for op, bounds in cell.spans.bounds().items():
                calls = [(b, by, device[seq]) for seq, b, by in bounds if seq in device]
                self.untraced_calls += len(bounds) - len(calls)
                self.op_calls[op] = calls

    def span_ms(self, name: str, parent: str = None) -> float:
        return sum(s["ms"] for s in self.spans
                   if s["name"] == name and (parent is None or s["parent"] == parent))


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    workload = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if workload is None:
        _err(f"no workload named {args.workload!r} in BENCHMARK.json")
        return 2
    parts = {}
    t = time.perf_counter()
    import torch
    import mitoflex_tpu_torch  # noqa: F401
    from mfxbench import devtrace, harness

    parts["imports"] = time.perf_counter() - t
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
            _err(f"{args.workload} needs {workload['chips']} CUDA device(s); "
                 f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        t = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        parts["cuda_init"] = time.perf_counter() - t
        card_line = card()
        print(f"card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}",
              flush=True)
    else:
        card_line = "no card"

    cell = harness.Cell(workload, args.seed, device=device)
    try:
        cell.setup(args.seconds)
        setup_s = AGE0 + time.perf_counter() - T0
        parts.update(cell.setup_parts)
        print("setup: " + json.dumps({"setup_s": setup_s, "process_before_main_s": AGE0,
                                      **parts, "pool_samples": len(cell.samples)}), flush=True)
        launch_fns = harness.launch_counters()
        before = {k: getattr(fn, "launches", 0) for k, fn in launch_fns.items()}
        trace = {}
        usage0 = host_usage()
        if args.trace:
            window_s = cell.window(args.seconds, traced=True, around=lambda s, run: trace.update(
                devtrace.trace_sample(s, run, cell.tmp)))
        else:
            window_s = cell.window(args.seconds)
        print("host: " + json.dumps(host_line(usage0, host_usage())), flush=True)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        n = max(len(cell.done), 1)
        launches = {k: (getattr(fn, "launches", 0) - before[k]) / n
                    for k, fn in harness.launch_counters().items()}
        for s in cell.done:
            print(f"sample {s.index}: {s.seconds:.3f} s, {s.bases} bases"
                  + (f", FAILED:\n{s.error}" if s.error else ""), flush=True)
        print("walls: " + json.dumps(cell.spans.walls), flush=True)
        if cell.spans.spans:
            print("spans: " + json.dumps(cell.spans.spans), flush=True)
        print("launches a sample: " + json.dumps(launches), flush=True)

        readings = Readings(cell, window_s, setup_s, trace)
        kind = "per_layer" if args.trace else "end_to_end"
        metrics = {}
        for spec in metric_specs(bench, args.workload, kind):
            value = harness.load_module("metrics", spec["name"]).read(readings)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        if args.trace:
            print(f"op calls whose range the trace lacks: {readings.untraced_calls}", flush=True)
            for op, calls in readings.op_calls.items():
                by = sorted({c[1] for c in calls})
                print(f"roofline {op}: {len(calls)} calls, bound {sum(c[0] for c in calls):.6f} "
                      f"ms by {by}, device {sum(c[2] for c in calls):.6f} ms; peaks of "
                      f"work/peaks.py against a card of {card_line}", flush=True)

        cell.spans.calls.clear()
        if device == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks = cell.check()
        print(f"comparison: {time.perf_counter() - t:.3f} s", flush=True)
        found = harness.forbidden_modules()
        if found:
            _err(f"modules loaded that the benchmark must not load: {found}")
            return 3
        failed = sum(1 for s in cell.done if s.error)
        correct = cell.verdict(checks)
        result = {
            "correct": correct, "attempted": len(cell.done), "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if device == "cuda" else device,
                       "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                       "count": workload["chips"], "memory_peak_bytes": int(peak)},
        }
        if args.trace:
            result["device"].update(busy_s=trace["busy_s"], window_s=trace["window_s"])
            result["breakdown"] = {"device_ops": trace["device_ops"],
                                   "idle_gaps": trace["idle_gaps"]}
        result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                            for c in checks}
        for c in checks:
            _err(f"{c['name']}: {c['value']!r} (limit {c['limit']!r})"
                 + ("" if c["ok"] else "  FAILED"))
        print(json.dumps(result, allow_nan=True), flush=True)
        return 0
    finally:
        cell.close()


if __name__ == "__main__":
    sys.exit(main())
