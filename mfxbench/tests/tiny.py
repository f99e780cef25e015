"""A copy of the benchmark with one more configuration, traffic mix, metric
and two cells of its own, small enough for the CPU: what a later change
adds, as files and BENCHMARK.json entries only."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TINY_MITO = {
    "clade": "Testa", "genetic_code": 5, "seed": 12,
    "pcg_lengths": {"COX1": 300, "ND1": 240, "ATP6": 210, "CYTB": 270},
    "trna_codons": {"F": "TTC", "H": "CAC", "K": "AAA", "W": "TGA"},
    "rrna_clen": {"rrnS": 200, "rrnL": 230},
    "gene_order": [["trnF", 1], ["COX1", 1], ["trnH", -1], ["ND1", -1], ["rrnS", 1],
                   ["ATP6", 1], ["trnK", 1], ["rrnL", -1], ["CYTB", -1], ["trnW", 1]],
    "spacer": [120, 240], "control_region": 300,
    "protein_taxa": ["Drosophila_melanogaster", "Apis_mellifera", "Bombyx_mori"],
    "divergence": [0.0, 0.2],
}


def make(dst: str) -> str:
    """The benchmark copied under ``dst`` with the tiny additions; returns
    the copy's root."""
    root = os.path.join(dst, "checkout")
    shutil.copytree(BENCH_DIR, os.path.join(root, "mfxbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "mitoflex_tpu_torch"), os.path.join(root, "mitoflex_tpu_torch"))
    b = os.path.join(root, "mfxbench")
    base = json.load(open(os.path.join(b, "configs", "arthropod_all.json")))
    tiny_all = dict(base, name="tiny_all", mitogenome=TINY_MITO, reduced=[],
                    pipeline={"filter": {"ns_valve": 10, "quality_valve": 55,
                                         "percentage_valve": 0.2, "batch_reads": 1024,
                                         "max_read_len": 128},
                              "assemble": {"kmer_list": [21, 41], "depth_list": [5, 5],
                                           "read_chunk": 1024},
                              "search": {"disable_taxa": True, "min_abundance": 10.0},
                              "annotate": {"clade": "Testa", "genetic_code": 5},
                              "visualize": {"disable_visualization": True}})
    tiny_scaf = dict(tiny_all, name="tiny_scaf", entry="scaf")
    for c in (tiny_all, tiny_scaf):
        with open(os.path.join(b, "configs", f"{c['name']}.json"), "w") as f:
            json.dump(c, f)
    wgs = json.load(open(os.path.join(b, "traffic", "wgs.json")))
    with open(os.path.join(b, "traffic", "tiny_wgs.json"), "w") as f:
        json.dump(dict(wgs, read_len=100, insert_mean=250, insert_sd=20, mito_coverage=60,
                       nuclear_length=3000, nuclear_coverage=20), f)
    draft = json.load(open(os.path.join(b, "traffic", "draft.json")))
    with open(os.path.join(b, "traffic", "tiny_draft.json"), "w") as f:
        json.dump(dict(draft, nuclear_bases=20000, circle_overlap=40), f)
    with open(os.path.join(b, "metrics", "samples_done.py"), "w") as f:
        f.write('"""Samples finished in the window."""\n\n\ndef read(r):\n'
                '    return float(r.samples)\n')
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"] += [{"name": n, "source": "tests", "file": f"mfxbench/configs/{n}.json",
                          "reduced": [], "why": "CPU tests"} for n in ("tiny_all", "tiny_scaf")]
    bench["workloads"] += [
        {"name": "tiny.all", "config": "tiny_all", "traffic": "tiny_wgs", "chips": 1, "why": "t"},
        {"name": "tiny.scaf", "config": "tiny_scaf", "traffic": "tiny_draft", "chips": 1,
         "why": "t"}]
    bench["end_to_end"].append({"name": "samples_done", "unit": "samples", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.all", "tiny.scaf"]})
    if not any(m["name"] == "scaf_mbp_per_s" for m in bench["end_to_end"]):
        # the draft cell is out of BENCHMARK.json until the program's partial
        # merge is mended; its rate stays tested on the tiny cell
        bench["end_to_end"].append({"name": "scaf_mbp_per_s", "unit": "Mbp/s",
                                    "better": "higher", "bound": 0.25,
                                    "source": "host_clock", "workloads": []})
    for m in bench["end_to_end"]:
        if m["name"] == "all_mbp_per_s":
            m["workloads"].append("tiny.all")
        if m["name"] == "scaf_mbp_per_s":
            m["workloads"].append("tiny.scaf")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


def start_cpu(root: str, workload: str, seed: int = 7, seconds: float = 1.0,
              fault: str = "") -> subprocess.Popen:
    """One run of the copy's ``run.main`` on the CPU, in a fresh interpreter,
    past the look for a card, with ``fault`` (of ``faults.py``) planted
    underneath; it prints the top-level names of the loaded modules last."""
    code = (
        "import sys, json\n"
        "from mfxbench import faults, harness, run\n"
        + (f"faults.plant(harness.Patches(), {fault!r})\n" if fault else "")
        + f"rc = run.main(['--workload', {workload!r}, '--seed', '{seed}', '--seconds', "
        f"'{seconds}', '--trace', '0'], device='cpu')\n"
        "print('MODULES ' + json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_control_cpu(root: str, workload: str, seed: int = 7,
                      faults: str = "") -> subprocess.Popen:
    """``control.py`` of the copy on the CPU, in a fresh interpreter."""
    code = ("import sys\n"
            "from mfxbench import control\n"
            f"sys.exit(control.main(['--workload', {workload!r}, '--seeds', '{seed}', "
            f"'--faults', {faults!r}], device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: int = 900):
    """(exit code, the result line, loaded top-level module names, stderr)."""
    out, err = proc.communicate(timeout=timeout)
    lines = out.splitlines()
    modules = json.loads(lines[-1][len("MODULES "):]) if lines and lines[-1].startswith(
        "MODULES ") else []
    result = next((json.loads(x) for x in reversed(lines) if x.startswith("{")), None)
    return proc.returncode, result, modules, err
