"""The benchmark's harness: a cell's set-up, its window and its comparison.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; everything else is found by name:

    configs/<config>.json     the deployment: its source, its cuts, the
                              pipeline settings, the mitogenome and profile
                              set, and the entry that runs a sample
    traffic/<traffic>.json    the mix's parameters and its generator
    entries/<entry>.py        ``run(ctx, sample)``: one sample through the
                              port; ``CHECKS``: the comparisons it answers to
    generators/<name>.py      ``generate(mito, params, seed, index, dir)``
    checks/<name>.py          ``LIMIT``, ``compare(run) -> number``
    metrics/<name>.py         ``read(readings) -> number or None``
    work/<op>.py              ``OP``, ``record(args, kwargs, out)``, ``bound(rec)``

The window runs whole samples back to back through the entry, one caller,
and ends with the first sample that finishes after ``seconds``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import importlib.util
import json
import math
import os
import random
import re
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

from .spans import Spans

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "mitoflex_tpu")
WARMUP_INDEX = 1 << 20       # the warm-up sample's index: never a pool index
MAX_POOL = 64
KEEP_CALLS = 4               # Viterbi calls of each pass kept for the comparison
FAILED_COMPARISON = 1e9      # the number of a comparison that could not be made


def load_json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark as a module of the package (a
    name may hold dots, so it is loaded from its path)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    modname = f"mfxbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def work_modules() -> Dict[str, object]:
    """Every work file that names an op: op name -> module."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "work", "*.py"))):
        mod = load_module("work", os.path.splitext(os.path.basename(path))[0])
        if hasattr(mod, "OP"):
            out[mod.OP[1]] = mod
    return out


def launch_counters() -> Dict[str, object]:
    """The port's kernel wrappers that count their launches (``.launches``),
    by op: every op a work file names, and the banded CYK's."""
    import importlib

    ops = {op: w.OP[0] for op, w in work_modules().items()}
    ops["cyk_banded_device"] = "mitoflex_tpu_torch.ops.cyk_device"
    return {op: getattr(importlib.import_module(mod), op) for op, mod in ops.items()}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``mitoflex_tpu_torch`` is not ``mitoflex_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Sample:
    index: int
    inputs: Dict[str, str]
    bases: int
    truth: object
    workdir: str = ""
    outputs: Optional[dict] = None
    seconds: float = 0.0
    error: str = ""


class Patches:
    """Module attributes replaced for a while, then put back. A kernel
    wrapper counts its launches on the module attribute of its own name, so
    a replacement carries a ``launches`` counter, added to the original's
    when it is put back."""

    def __init__(self) -> None:
        self._saved: List[tuple] = []

    def wrap(self, module, name: str, make: Callable) -> None:
        real = getattr(module, name)
        repl = make(real)
        if hasattr(real, "launches"):
            repl.launches = 0
        setattr(module, name, repl)
        self._saved.append((module, name, real, repl))

    def restore(self) -> None:
        for module, name, real, repl in reversed(self._saved):
            setattr(module, name, real)
            if hasattr(real, "launches"):
                real.launches += getattr(repl, "launches", 0)
        self._saved.clear()


class Stage:
    """The stage the window is in, for recorders that keep calls of one
    stage only."""

    def __init__(self) -> None:
        self.name = ""


class ViterbiRecorder:
    """Keeps up to KEEP_CALLS of each Viterbi pass made under findmitoscaf
    (a reservoir drawn from the seed): references to the call's inputs and
    its output, no copy and no device sync, for the comparison once the
    window has closed."""

    PASSES = ("viterbi_scores_multi", "viterbi_scan")

    def __init__(self, seed: int, stage: Stage) -> None:
        self.rng = random.Random(seed)
        self.stage = stage
        self.kept: Dict[str, list] = {p: [] for p in self.PASSES}
        self.seen = {p: 0 for p in self.PASSES}
        self.active = False
        self.keeping = False

    def install(self, patches: Patches, phmm) -> None:
        for name in self.PASSES:
            patches.wrap(phmm, name, lambda real, name=name: self._wrap(name, real))

    def _wrap(self, name: str, real):
        def run(*args, **kwargs):
            slot = None
            if self.active and self.stage.name == "findmitoscaf":
                n = self.seen[name] = self.seen[name] + 1
                kept = self.kept[name]
                slot = len(kept) if len(kept) < KEEP_CALLS else self.rng.randrange(n)
                if slot >= KEEP_CALLS:
                    slot = None
            # the call's fate is known while it runs, so that the control
            # (control.py) takes the place of exactly the calls compared
            self.keeping = slot is not None
            try:
                out = real(*args, **kwargs)
            finally:
                self.keeping = False
            if slot is not None:
                if slot == len(self.kept[name]):
                    self.kept[name].append((args, kwargs, out))
                else:
                    self.kept[name][slot] = (args, kwargs, out)
            return out
        return run


class Cell:
    """One workload: its configuration, traffic and entry, a pool of
    samples from the seed, the window and the comparison."""

    def __init__(self, workload: dict, seed: int, device: str = "cuda",
                 tmp_root: Optional[str] = None) -> None:
        self.workload = workload
        self.seed = int(seed)
        self.device = device
        self.config = load_json("configs", f"{workload['config']}.json")
        self.traffic = load_json("traffic", f"{workload['traffic']}.json")
        self.entry = load_module("entries", self.config["entry"])
        self.generator = load_module("generators", self.traffic["generator"])
        self.tmp = tempfile.mkdtemp(prefix="mfxbench-", dir=tmp_root)
        self.samples: List[Sample] = []
        self.done: List[Sample] = []
        self.setup_parts: Dict[str, float] = {}
        self.stage = Stage()
        self.viterbi = ViterbiRecorder(self.seed, self.stage)
        self.spans = Spans(self.stage, traced=False)
        self.program_log = open(os.path.join(self.tmp, "program.log"), "w")
        self.mito = None
        self.ctx = None

    # ------------------------------------------------------------ set-up
    def quiet(self):
        """The program's own stdout (its log lines) goes to a file, so that
        the run's last stdout line is the result."""
        return contextlib.redirect_stdout(self.program_log)

    def _timed(self, part: str, fn, *a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            self.setup_parts[part] = self.setup_parts.get(part, 0.0) + time.perf_counter() - t0

    def pipeline_config(self):
        from mitoflex_tpu_torch.config import PipelineConfig

        cfg = PipelineConfig.from_dict(self.config.get("pipeline", {}))
        cfg.run.basedir = os.path.join(self.tmp, "setup")
        cfg.run.workname = "mfx"
        cfg.run.profile_dir = self.mito.profile_dir
        return cfg

    def make_sample(self, index: int) -> Sample:
        out = os.path.join(self.tmp, "samples", str(index))
        inputs, bases, truth = self.generator.generate(self.mito, self.traffic, self.seed,
                                                       index, out)
        return Sample(index, inputs, bases, truth)

    def setup(self, seconds: float) -> None:
        """Libraries, the configuration's data, the context, one warm-up
        sample of the cell's own traffic, then the pool the window needs."""
        from mitoflex_tpu_torch import kernels, pipeline
        from mitoflex_tpu_torch.native import fastq_native
        from .generators import mitogenome

        with self.quiet():
            if self.device == "cuda":
                self._timed("kernel_library", kernels.library)
                self.setup_parts["kernel_library_built_s"] = kernels.last_build_seconds
            self._timed("host_library", kernels.host_library)
            self.setup_parts["host_library_built_s"] = getattr(
                fastq_native, "last_build_seconds", 0.0)
            self.mito = self._timed("data", mitogenome.build, self.config["mitogenome"],
                                    os.path.join(self.tmp, "config"))
            self.ctx = self._timed("context", pipeline.PipelineContext.create,
                                   self.pipeline_config(), device=self.device)
            warm = self._timed("data", self.make_sample, WARMUP_INDEX)
            self._timed("warmup", self.run_sample, warm)
            if warm.error:
                raise RuntimeError(f"the warm-up sample failed:\n{warm.error}")
            shutil.rmtree(warm.workdir, ignore_errors=True)
            n = min(MAX_POOL, math.ceil(1.5 * seconds / max(warm.seconds, 1e-3)) + 1)
            self.samples = [self._timed("data", self.make_sample, i) for i in range(n)]
            # the samples' files reach the disk, and the heap is swept, before
            # the window: neither is left to happen inside it
            self._timed("data", os.sync)
            gc.collect()

    # ------------------------------------------------------------ window
    def run_sample(self, sample: Sample) -> None:
        """One sample through the entry in a fresh work directory."""
        from mitoflex_tpu_torch.utils.workdir import WorkDir

        sample.workdir = os.path.join(self.tmp, "runs", str(sample.index))
        ctx = dataclasses.replace(self.ctx, workdir=WorkDir(sample.workdir, "mfx").create())
        t0 = time.perf_counter()
        try:
            sample.outputs = self.entry.run(ctx, sample)
        except Exception:  # a failed sample is counted, the window goes on
            sample.error = traceback.format_exc()
        sample.seconds = time.perf_counter() - t0

    def window(self, seconds: float, traced: bool = False,
               around: Optional[Callable] = None) -> float:
        """Samples back to back until one finishes after ``seconds``;
        returns the window's seconds. A traced window is its first sample
        alone, with the harness's spans and op ranges; ``around(sample,
        fn)`` wraps each sample (the traced run's profiler)."""
        from mitoflex_tpu_torch.ops import phmm

        patches = Patches()
        self.spans = Spans(self.stage, traced=traced)
        self.viterbi.install(patches, phmm)
        self.spans.install(patches)
        self.viterbi.active = True
        try:
            with self.quiet():
                t0 = time.perf_counter()
                i = 0
                while True:
                    s = self.samples[i % len(self.samples)]
                    if i >= len(self.samples):  # the pool ran out: a sample again
                        s = dataclasses.replace(s, index=s.index + (i // len(self.samples))
                                                * MAX_POOL)
                    self.spans.sample = s.index
                    if around is None:
                        self.run_sample(s)
                    else:
                        around(s, self.run_sample)
                    self.done.append(s)
                    i += 1
                    if traced or time.perf_counter() - t0 >= seconds:
                        break
                return time.perf_counter() - t0
        finally:
            self.viterbi.active = False
            patches.restore()

    # -------------------------------------------------------- comparison
    def check(self) -> List[dict]:
        """Every comparison the entry answers to, each number beside its
        limit, on the window's samples."""
        rows = []
        with self.quiet():
            for name in self.entry.CHECKS:
                mod = load_module("checks", name)
                try:
                    value = float(mod.compare(self))
                except Exception:  # a comparison that cannot be made fails
                    print(traceback.format_exc(), file=sys.stderr)
                    value = FAILED_COMPARISON
                rows.append({"name": name, "value": value, "limit": mod.LIMIT,
                             "ok": value <= mod.LIMIT})
        return rows

    def verdict(self, rows: List[dict]) -> bool:
        """``correct``: every sample finished and every number is within
        its limit."""
        return not any(s.error for s in self.done) and all(r["ok"] for r in rows)

    def close(self) -> None:
        self.program_log.close()
        shutil.rmtree(self.tmp, ignore_errors=True)
