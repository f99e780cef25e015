"""`mitoflex findmitoscaf --from-megahit` and then `annotate` on one draft
assembly: ``pipeline.run_findmitoscaf`` and ``pipeline.run_annotate`` on
the picked FASTA. Ends in a device sync."""

from __future__ import annotations

CHECKS = ("circle_diff_bases", "picked_extra", "pcg_hits_missed", "genes_missed",
          "gene_end_gap_nt", "viterbi_gap_bits")


def run(ctx, sample) -> dict:
    import torch
    from mitoflex_tpu_torch import pipeline

    found = pipeline.run_findmitoscaf(ctx, sample.inputs["contigs"], from_megahit=True)
    pipeline.run_annotate(ctx, found.path)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    name = ctx.cfg.run.workname
    return {"picked": found.path, "workname": name,
            "annotation": ctx.workdir.stage_dir("annotation"),
            "hmm_frame": ctx.workdir.stage_file("findmitoscaf", f"{name}.taxa.csv")}
