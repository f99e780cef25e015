"""The readers of the port's spans and counters (``porttrace.py`` and its six
metrics) on a synthetic export, on a port without the tracer, and a
``--trace 0`` run that never turns the port's tracer on."""

import json
import os
import subprocess
import sys
import types

import pytest

from mfxbench import harness
from mfxbench.tests import tiny

MAIN, HELPER = 1, 2


def _span(name, ms, thread=MAIN, **counters):
    return {"name": name, "attrs": {}, "thread": thread, "t0_ns": 0, "t1_ns": int(ms * 1e6),
            "counters": counters}


EXPORT = {"main_thread": MAIN, "anchors": [], "spans": [
    _span("filter", 900.0),
    _span("filter.read_wait", 40.0, **{"io.wait_ns": 40e6}),
    _span("filter.device", 80.0, **{"d2h.wait_ns": 30e6, "d2h.bytes": 1000}),
    _span("io.parse", 300.0, thread=HELPER),
    _span("prefetch", 320.0, thread=HELPER, **{"io.put_blocked_ns": 5e6, "d2h.wait_ns": 2e6}),
    _span("assemble.k", 3000.0),
    _span("assemble.count", 1000.0),
    _span("count.add", 800.0, **{"io.wait_ns": 100e6, "count.bases": 4_000_000}),
    _span("count.gate", 100.0, **{"merge.wait_ns": 50e6}),
    _span("assemble.mercy", 500.0, **{"io.wait_ns": 60e6}),
    _span("assemble.graph", 400.0),
    _span("assemble.local", 700.0, **{"d2h.wait_ns": 8e6}),
    _span("assemble.k", 2000.0),
    _span("assemble.count", 600.0),
    _span("assemble.graph", 200.0),
    _span("assemble.local", 300.0),
    _span("annotate.trna", 1400.0),
    dict(_span("assemble.local", 0.0), t1_ns=None),  # still open: not counted
]}

# metric -> value read from EXPORT over 4 Mbp in one sample
WANT = {
    "count_ms_per_mbp.all": (1000 + 500 + 600) / 4,
    "graph_ms_per_mbp.all": (400 + 200) / 4,
    "local_ms_per_mbp.all": (700 + 300) / 4,
    "read_wait_ms_per_mbp.all": (40 + 100 + 60) / 4,
    "d2h_wait_ms_per_mbp.all": (30 + 2 + 8) / 4,
    "trna_search_ms.all": 1400.0,
}


def _readings(**kw):
    return types.SimpleNamespace(bases=4_000_000, samples=1, **kw)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_mfxbench_port_metric_reads_the_export(metric):
    mod = harness.load_module("metrics", metric)
    assert mod.read(_readings(port_trace=EXPORT)) == pytest.approx(WANT[metric])
    spec = next(m for m in json.load(open(f"{harness.ROOT}/BENCHMARK.json"))["per_layer"]
                if m["name"] == metric)
    assert spec["workloads"] == ["all.wgs"] and spec["moves"] == "all_mbp_per_s"


@pytest.mark.parametrize("metric", sorted(WANT))
def test_mfxbench_port_metric_reads_nothing_without_the_tracer(metric, monkeypatch):
    mod = harness.load_module("metrics", metric)
    # a port without utils/trace.py (an import of it fails)
    monkeypatch.setitem(sys.modules, "mitoflex_tpu_torch.utils.trace", None)
    assert mod.read(_readings()) is None
    assert mod.read(_readings(port_trace={"main_thread": MAIN, "anchors": [],
                                          "spans": []})) is None


def test_mfxbench_port_metric_reads_the_live_tracer():
    from mitoflex_tpu_torch.utils import trace

    trace.reset()
    trace.enable()
    try:
        with trace.span("assemble.k", k=31):
            with trace.span("assemble.graph"):
                pass
    finally:
        trace.disable()
    try:
        got = harness.load_module("metrics", "graph_ms_per_mbp.all").read(_readings())
        assert got is not None and got >= 0
        assert harness.load_module("metrics", "trna_search_ms.all").read(_readings()) is None
    finally:
        trace.reset()


def test_mfxbench_untraced_run_never_turns_the_tracer_on(tmp_path):
    """``--trace 0``: the port's tracer is never enabled and records
    nothing over the whole run (set-up, warm-up, window, comparison)."""
    root = tiny.make(str(tmp_path))
    code = (
        "import sys, json\n"
        "from mitoflex_tpu_torch.utils import trace\n"
        "calls = []\n"
        "real = trace.enable\n"
        "trace.enable = lambda: calls.append(1) or real()\n"
        "from mfxbench import run\n"
        "rc = run.main(['--workload', 'tiny.all', '--seed', '3', '--seconds', '1', "
        "'--trace', '0'], device='cpu')\n"
        "print('TRACER ' + json.dumps({'enabled': len(calls), 'recording': trace.recording(), "
        "'spans': len(trace.export()['spans'])}))\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": root,
                            "OMP_NUM_THREADS": "2"}, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("TRACER "))
    assert json.loads(line[len("TRACER "):]) == {"enabled": 0, "recording": False, "spans": 0}
    result = next(json.loads(x) for x in reversed(r.stdout.splitlines()) if x.startswith("{"))
    assert result["correct"] is True
    assert not set(result["metrics"]) & set(WANT)
