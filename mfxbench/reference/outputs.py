"""Reading the files a sample's run left, without the program's readers."""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List

from .truth import read_fasta


def picked(outputs: dict):
    return [(name, seq) for name, _, seq in read_fasta(outputs["picked"])]


def locs(outputs: dict) -> dict:
    with open(os.path.join(outputs["annotation"], "locs.json")) as f:
        return json.load(f)


def fragments(outputs: dict) -> Dict[str, str]:
    """gene name -> annotated fragment, from the annotated CDS and RNA FASTAs."""
    out = {}
    for kind in ("cds", "rna"):
        path = os.path.join(outputs["annotation"], f"{outputs['workname']}.annotated.{kind}.fa")
        if os.path.exists(path):
            for _, attrs, seq in read_fasta(path):
                out[attrs.get("gene", "")] = seq
    return out


def frame_rows(outputs: dict) -> List[dict]:
    with open(outputs["hmm_frame"], newline="") as f:
        return list(csv.DictReader(f))


def depth_rows(path: str) -> Dict[str, list]:
    """contig -> depths in position order, from ``contig pos pos depth`` rows."""
    out: Dict[str, list] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                out.setdefault(parts[0], []).append(int(parts[3]))
    return out
