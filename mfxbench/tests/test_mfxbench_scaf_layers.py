"""The draft cell's layers: a traced run of the tiny draft cell on the CPU
reads the partial merge's port span (``merge_ms_per_mbp.scaf``) and no
share of S1's roofline without a CUDA trace (``sw_roofline_pct.scaf``,
which reads the S1 calls' bounds over their device time), and
``BENCHMARK.json`` has ``scaf.draft`` report the benchmark's end-to-end
rate."""

import json
import os
import subprocess
import sys
import types

from mfxbench import harness
from mfxbench.tests import tiny

LAYERS = ("merge_ms_per_mbp.scaf", "sw_roofline_pct.scaf")


def test_mfxbench_scaf_draft_reports_the_rate():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    rate = next(m for m in bench["end_to_end"] if m["name"] == "all_mbp_per_s")
    assert "scaf.draft" in rate["workloads"]
    cell = next(w for w in bench["workloads"] if w["name"] == "scaf.draft")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("arthropod_scaf", "draft", 1)
    for name in LAYERS:
        spec = next(m for m in bench["per_layer"] if m["name"] == name)
        assert spec["workloads"] == ["scaf.draft"] and spec["moves"] == "all_mbp_per_s"


def test_mfxbench_traced_tiny_draft_reads_the_merge_and_s1(tmp_path):
    root = tiny.make(str(tmp_path))
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    for m in bench["per_layer"]:
        if m["name"] in LAYERS:
            m["workloads"].append("tiny.scaf")
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    # a smaller draft: the CPU's eager Smith-Waterman takes 36 s over 20 kb
    draft = os.path.join(root, "mfxbench", "traffic", "tiny_draft.json")
    with open(draft) as f:
        params = json.load(f)
    with open(draft, "w") as f:
        json.dump(dict(params, nuclear_bases=3000), f)
    # torch.profiler over the CPU's eager loops records millions of events
    # (some 18 GB to export and read back at this size), so the port's own
    # tracer, which the profiler turns on in a card's run, stands in for it:
    # the traced sample's spans are the same, and no device time is read
    code = ("import sys\n"
            "from mfxbench import devtrace, run\n"
            "from mitoflex_tpu_torch.utils import trace\n"
            "def trace_sample(sample, run_sample, out_dir):\n"
            "    trace.enable()\n"
            "    try:\n"
            "        run_sample(sample)\n"
            "    finally:\n"
            "        trace.disable()\n"
            "    return devtrace.reduce([{'ph': 'X', 'cat': 'user_annotation', "
            "'name': 'mfx.sample', 'ts': 0, 'dur': 1}])\n"
            "devtrace.trace_sample = trace_sample\n"
            "sys.exit(run.main(['--workload', 'tiny.scaf', '--seed', '4100000023', "
            "'--seconds', '1', '--trace', '1'], device='cpu'))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "2"},
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    assert metrics["merge_ms_per_mbp.scaf"]["value"] > 0
    assert metrics["merge_ms_per_mbp.scaf"]["unit"] == "ms/Mbp"
    assert "sw_roofline_pct.scaf" not in metrics  # no CUDA trace: nothing to read


def test_mfxbench_sw_roofline_reads_the_s1_calls():
    """S1's calls alone, each (bound ms, bounded by, device ms) as
    ``run.Readings`` holds them: the summed bound over the summed device
    time."""
    read = harness.load_module("metrics", "sw_roofline_pct.scaf").read
    calls = {"sw_align": [(0.5, "operations", 2.0), (0.25, "bytes", 4.0)],
             "viterbi_scan": [(1.0, "operations", 1.0)]}
    assert read(types.SimpleNamespace(op_calls=calls)) == 100.0 * 0.75 / 6.0
    assert read(types.SimpleNamespace(op_calls={"sw_align": []})) is None
