"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (half of a batch left out, an answer altered
where it is produced; no cell trains or spans chips), and with the control
(the reference's Viterbi in bfloat16) in the program's place. The tiny
cells on the CPU, past the look for a card, all runs at once."""

import json

import pytest

from mfxbench.tests import tiny

RUNS = [("tiny.all", ""), ("tiny.all", "filter_half"), ("tiny.all", "depth_half"),
        ("tiny.all", "viterbi_shift"), ("tiny.all", "genewise_start_cut"),
        ("tiny.scaf", "viterbi_half"), ("tiny.scaf", "viterbi_shift"),
        ("tiny.scaf", "genewise_start_cut")]
CONTROLS = ["tiny.all", "tiny.scaf"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tiny.make(str(tmp_path_factory.mktemp("faults")))
    procs = {run: tiny.start_cpu(root, run[0], seed=17, fault=run[1]) for run in RUNS}
    procs.update({("control", w): tiny.start_control_cpu(root, w, seed=19)
                  for w in CONTROLS})
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=1200)
        out[key] = (p, stdout, stderr)
    return out


@pytest.mark.parametrize("run", RUNS, ids=[f"{w}-{f or 'sound'}" for w, f in RUNS])
def test_mfxbench_fault_is_caught(results, run):
    p, stdout, stderr = results[run]
    lines = stdout.splitlines()
    result = next((json.loads(x) for x in reversed(lines) if x.startswith("{")), None)
    assert p.returncode == 0, stderr[-3000:]
    failing = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    if run[1]:
        assert result["correct"] is False and failing, result["checks"]
    else:
        assert result["correct"] is True and not failing, result["checks"]


@pytest.mark.parametrize("workload", CONTROLS)
def test_mfxbench_control_is_caught(results, workload):
    p, stdout, stderr = results[("control", workload)]
    assert p.returncode == 0, stderr[-3000:]
    line = json.loads(stdout.splitlines()[-1])
    assert line["control"]["correct"] is False, line
    assert line["control"]["viterbi_gap_bits"] > 0.05, line
