"""The comparison's control and its planted faults, at a cell's own size.

    python -m mfxbench.control --workload <name> --seeds 1,2,3 \
        [--faults depth_half,genewise_start_cut]

For each seed, in one process: the cell's set-up, then a one-sample window
with the control in the program's place and another under each planted
fault (``faults.py``), each followed by the cell's whole comparison and its
verdict, as a run of ``run.py`` reaches it. The control is the reference's
Viterbi in bfloat16, below the float32 that the configuration states: it
takes the place of nhmmer's passes (V1 ``viterbi_scores_multi``, V2
``viterbi_scan``) in every call whose output the comparison keeps, and
works from the call's windows and the profile set's HMM text, not from the
program's staged arrays. One JSON line a seed. The benchmark's own runs
(``run.py``) never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import faults, harness
from .checks import viterbi_gap_bits
from .reference import viterbi as ref_viterbi

NO_ALIGNMENT = -1e30  # the program's score of a window with no alignment


def _bf16_pass(cell, name: str, real):
    def run(*args, **kwargs):
        out = real(*args, **kwargs)
        if not cell.viterbi.keeping:
            return out
        models = cell.control_models
        names = viterbi_gap_bits.names_by_length(cell)
        W = viterbi_gap_bits.window_of(name, args, kwargs)
        if name == "viterbi_scores_multi":
            _, lens, seqs, lengths = args[:4]
        else:
            _, seqs, lengths, L = args[:4]
            lens = [L]
        ref = ref_viterbi.scores_multi([models[names[int(L)]] for L in lens],
                                       seqs.detach().cpu().numpy(),
                                       lengths.detach().cpu().numpy(), W, torch.bfloat16,
                                       cell.device)
        ref = torch.as_tensor(ref, device=seqs.device).clamp_min(NO_ALIGNMENT).float()
        if name == "viterbi_scores_multi":
            return ref
        return out._replace(score=ref[0])
    return run


def plant_control(patches, cell) -> None:
    """The bfloat16 reference in the place of the compared Viterbi calls."""
    from mitoflex_tpu_torch.ops import phmm

    cell.control_models = viterbi_gap_bits.models(cell)
    for name in harness.ViterbiRecorder.PASSES:
        patches.wrap(phmm, name, lambda real, name=name: _bf16_pass(cell, name, real))


def _one_sample(cell, plant) -> dict:
    """A one-sample window with ``plant(patches)`` in place, then every
    compared number and the verdict."""
    cell.done = []
    cell.viterbi = harness.ViterbiRecorder(cell.seed, cell.stage)
    patches = harness.Patches()
    plant(patches)
    try:
        cell.window(0.0)
    finally:
        patches.restore()
    rows = cell.check()
    out = {c["name"]: c["value"] for c in rows}
    out["failed_samples"] = sum(1 for s in cell.done if s.error)
    out["correct"] = cell.verdict(rows)
    return out


def run_seed(workload: dict, seed: int, fault_names, device: str) -> dict:
    cell = harness.Cell(workload, seed, device=device)
    try:
        cell.setup(0.0)
        out = {"seed": seed}
        if "viterbi_gap_bits" in cell.entry.CHECKS:
            out["control"] = _one_sample(cell, lambda p: plant_control(p, cell))
        out["faults"] = {name: _one_sample(cell, lambda p, name=name: faults.plant(p, name))
                         for name in fault_names}
        return out
    finally:
        cell.close()


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    with open(f"{harness.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    workload = next(w for w in bench["workloads"] if w["name"] == args.workload)
    names = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload,
                          **run_seed(workload, seed, names, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
