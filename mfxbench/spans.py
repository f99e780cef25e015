"""The harness's own spans and op ranges, wrapped around the port from
outside (as ``chip_smoke.py`` wraps its stage and op functions).

Stage spans: each stage function the window reaches sets the stage's name
(the Viterbi recorder keeps calls of findmitoscaf only); in a traced run it
also opens a ``torch.profiler`` range ``mfx.stage.<name>`` and records a
host-clock span that ends in a device sync. ``nhmmer`` is a span inside the
stage that called it. Op ranges (traced runs only): each op that a file of
``work/`` names runs inside a range ``mfx.op.<op>#<call number>`` and its work is
recorded from its arguments, without a device sync, to be bounded after
the sample.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Dict, List

# (module, function, span name, nested): nested spans keep the stage's name
STAGES = (
    ("mitoflex_tpu_torch.pipeline", "run_filter", "filter", False),
    ("mitoflex_tpu_torch.pipeline", "run_assemble", "assemble", False),
    ("mitoflex_tpu_torch.pipeline", "run_findmitoscaf", "findmitoscaf", False),
    ("mitoflex_tpu_torch.pipeline", "run_annotate", "annotate", False),
    ("mitoflex_tpu_torch.stages.visualize", "build_tracks", "visualize", False),
    ("mitoflex_tpu_torch.models.nhmmer", "nhmmer_search", "nhmmer", True),
)


class Spans:
    def __init__(self, stage, traced: bool) -> None:
        self.stage = stage
        self.traced = traced
        self.spans: List[dict] = []
        self.calls: List[dict] = []
        self.walls: List[dict] = []
        self.sample = -1

    def _range(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def _sync(self) -> None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def install(self, patches) -> None:
        for modname, fn, label, nested in STAGES:
            patches.wrap(importlib.import_module(modname), fn,
                         lambda real, label=label, nested=nested: self._stage(real, label, nested))
        if self.traced:
            from .harness import work_modules

            for op, work in work_modules().items():
                patches.wrap(importlib.import_module(work.OP[0]), op,
                             lambda real, op=op, work=work: self._op(real, op, work))

    def _stage(self, real, label: str, nested: bool):
        def run(*args, **kwargs):
            prev = self.stage.name
            if not nested:
                self.stage.name = label
            t0 = time.perf_counter()
            try:
                with self._range(f"mfx.stage.{label}"):
                    out = real(*args, **kwargs)
                if isinstance(getattr(out, "walls", None), dict):
                    self.walls.append({"stage": label, "sample": self.sample, **out.walls})
                return out
            finally:
                if self.traced:
                    self._sync()
                    self.spans.append({"name": label, "parent": prev if nested else "",
                                       "sample": self.sample,
                                       "ms": (time.perf_counter() - t0) * 1e3})
                self.stage.name = prev
        return run

    def _op(self, real, op: str, work):
        def run(*args, **kwargs):
            seq = len(self.calls)
            with self._range(f"mfx.op.{op}#{seq}"):
                out = real(*args, **kwargs)
            self.calls.append({"op": op, "seq": seq, "sample": self.sample,
                               "rec": work.record(args, kwargs, out)})
            return out
        return run

    def bounds(self) -> Dict[str, list]:
        """op -> [(call number, bound ms, bounded by)] of its calls."""
        from .harness import work_modules

        works = work_modules()
        out: Dict[str, list] = {}
        for c in self.calls:
            out.setdefault(c["op"], []).append((c["seq"], *works[c["op"]].bound(c["rec"])))
        return out
