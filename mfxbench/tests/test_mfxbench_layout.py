"""The harness is driven by data: a copy of the benchmark with one more
configuration, traffic mix and metric (files and BENCHMARK.json entries,
no existing file edited) runs its new cell; and what it loads holds
neither JAX nor the JAX package, compared by whole top-level names."""

import filecmp
import os
import subprocess
import sys

import pytest

from mfxbench import harness
from mfxbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "mitoflex_tpu"}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def test_mfxbench_new_cell_from_files_alone(copy):
    cmp = filecmp.dircmp(harness.BENCH_DIR, os.path.join(copy, "mfxbench"),
                         ignore=["__pycache__", "tests"])

    def changed(c):
        return c.diff_files + [f for sub in c.subdirs.values() for f in changed(sub)]

    assert changed(cmp) == [] and cmp.left_only == []
    assert {"tiny_all.json", "tiny_scaf.json"} <= set(os.listdir(
        os.path.join(copy, "mfxbench", "configs")))
    rc, result, modules, err = tiny.finish(tiny.start_cpu(copy, "tiny.all"))
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    assert result["metrics"]["samples_done"] == {"value": 1.0, "unit": "samples"}
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert not FORBIDDEN & set(modules), modules
    assert "mitoflex_tpu_torch" in modules


def test_mfxbench_reference_loads_nothing_of_the_port():
    code = ("import sys, pkgutil, importlib, mfxbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('mfxbench.reference.' + m.name)\n"
            "for g in ('mitogenome', 'wgs_reads', 'draft_contigs'):\n"
            "    importlib.import_module('mfxbench.generators.' + g)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    names = set(eval(out))
    assert "mfxbench" in names
    assert not (FORBIDDEN | {"mitoflex_tpu_torch"}) & names, names


def test_mfxbench_refuses_without_a_card(copy):
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from mfxbench import run\n"
            "sys.exit(run.main(['--workload', 'tiny.all', '--seed', '1', '--seconds', '1']))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=copy))
    assert r.returncode != 0 and "{" not in r.stdout
