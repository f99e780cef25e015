"""Work-directory layout manager.

Reproduces the reference's on-disk stage contract (arguments.py:52-69,
188, 269, 349, 532): a ``<basedir>/<workname>/`` tree with

    <workname>.temp/cleandata/     filtered reads
    <workname>.temp/assemble/      assembly intermediates
    <workname>.temp/findmitoscaf/  candidate picking intermediates
    <workname>.temp/annotation/    annotation intermediates
    <workname>.temp/visualize/     plot inputs
    <workname>.result/             final outputs

Every stage's inputs and outputs are files in this tree, which is the
pipeline's de-facto checkpoint/resume mechanism: any stage can be re-run
standalone against the artifacts of the previous one (SURVEY.md §5
"Checkpoint/resume"). We additionally write a ``manifest.json`` per stage
recording inputs, outputs and parameters so resume can detect staleness.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from .helper import safe_makedirs

STAGES = ("cleandata", "assemble", "findmitoscaf", "annotation", "visualize")


@dataclass
class WorkDir:
    basedir: str
    workname: str
    _created: Dict[str, str] = field(default_factory=dict)

    @property
    def root(self) -> str:
        return os.path.join(self.basedir, self.workname)

    @property
    def temp(self) -> str:
        return os.path.join(self.root, f"{self.workname}.temp")

    @property
    def result(self) -> str:
        return os.path.join(self.root, f"{self.workname}.result")

    @property
    def log_path(self) -> str:
        return os.path.join(self.root, f"{self.workname}.log")

    def create(self) -> "WorkDir":
        safe_makedirs(self.root)
        safe_makedirs(self.result)
        for s in STAGES:
            safe_makedirs(self.stage_dir(s))
        return self

    def stage_dir(self, stage: str) -> str:
        return safe_makedirs(os.path.join(self.temp, stage))

    def stage_file(self, stage: str, name: str) -> str:
        return os.path.join(self.stage_dir(stage), name)

    def result_file(self, name: str) -> str:
        return os.path.join(self.result, name)

    # -- stage manifests: content-addressed-ish resume support ------------
    def write_manifest(self, stage: str, payload: dict) -> None:
        payload = dict(payload)
        payload["_written_at"] = time.time()
        with open(self.stage_file(stage, "manifest.json"), "w") as f:
            json.dump(payload, f, indent=2, default=str)

    def read_manifest(self, stage: str) -> Optional[dict]:
        p = self.stage_file(stage, "manifest.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def stage_complete(self, stage: str) -> bool:
        m = self.read_manifest(stage)
        if not m:
            return False
        outs = m.get("outputs", [])
        return bool(outs) and all(os.path.exists(o) for o in outs)

    def clean_temp(self) -> None:
        """Drop intermediates (reference `keep_temp=False` post hook,
        MitoFlex.py:471-476)."""
        if os.path.isdir(self.temp):
            shutil.rmtree(self.temp)
