"""`mitoflex all` on one WGS sample: ``pipeline.run_all`` with the figure
off, then the visualize stage's ``build_tracks`` on the card (the depth
remap of the clean reads and every track file), as the command would draw
the map from them. Ends in a device sync."""

from __future__ import annotations

import json
import os

CHECKS = ("clean_reads_diff", "circle_diff_bases", "picked_extra", "pcg_hits_missed",
          "genes_missed", "gene_end_gap_nt", "depth_gap", "viterbi_gap_bits")


def run(ctx, sample) -> dict:
    import torch
    from mitoflex_tpu_torch import pipeline
    from mitoflex_tpu_torch.io import fasta
    from mitoflex_tpu_torch.stages import visualize

    summary = pipeline.run_all(ctx, sample.inputs["fastq1"], sample.inputs["fastq2"])
    clean = ctx.workdir.read_manifest("cleandata")["outputs"]
    with open(summary["locs"]) as f:
        locs = json.load(f)
    name = ctx.cfg.run.workname
    prefix = os.path.join(ctx.workdir.stage_dir("visualize"), name)
    visualize.build_tracks(ctx.cfg.visualize, fasta.load_fasta(summary["picked"]), locs,
                           prefix, clean[0], clean[1], circular=summary["circular"],
                           device=ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return {"clean": clean, "picked": summary["picked"], "workname": name,
            "annotation": ctx.workdir.stage_dir("annotation"),
            "hmm_frame": ctx.workdir.stage_file("findmitoscaf", f"{name}.taxa.csv"),
            "depth": f"{prefix}.depth.txt"}
