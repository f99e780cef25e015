"""Pipeline orchestrator for the ported stages (filter, assemble).

Port of mitoflex_tpu/pipeline.py: each stage reads and writes files under
``<workname>.temp/<stage>/`` with a manifest, so a stage can be re-run on
its own. The context carries the run's ``torch.device``, which every stage
receives explicitly. findmitoscaf, annotate, visualize, ``run_all`` and
``run_bim`` are not ported yet (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from mitoflex_tpu.config import PipelineConfig
from mitoflex_tpu.models.profiles import ProfileSet, get_profiles
from mitoflex_tpu.models.taxonomy import Taxonomy, load_taxonomy
from mitoflex_tpu.utils.logger import logger
from mitoflex_tpu.utils.workdir import WorkDir

from .device import DeviceLike, resolve_device


@dataclass
class PipelineContext:
    cfg: PipelineConfig
    workdir: WorkDir
    device: torch.device
    profiles: Optional[ProfileSet] = None
    taxonomy: Optional[Taxonomy] = None

    @classmethod
    def create(cls, cfg: PipelineConfig, device: DeviceLike = None) -> "PipelineContext":
        wd = WorkDir(cfg.run.basedir, cfg.run.workname).create()
        logger.init(wd.log_path, cfg.run.log_level)
        dev = resolve_device(device)
        logger.info(f"pipeline: device {dev}")
        profiles = None
        try:
            profiles = get_profiles(cfg.run.profile_dir)
        except FileNotFoundError as e:
            logger.warn(f"profiles unavailable ({e}); search/annotate stages will fail")
        taxonomy = None
        if not cfg.search.disable_taxa:
            taxonomy = load_taxonomy(cfg.run.taxonomy_dump)
        return cls(cfg, wd, dev, profiles, taxonomy)


def run_filter(ctx: PipelineContext, fastq1: str, fastq2: Optional[str] = None,
               cleanq1: Optional[str] = None, cleanq2: Optional[str] = None):
    from .parallel.distributed import shard_info
    from .stages.filter import filter_reads

    wd = ctx.workdir
    pid, n_hosts = shard_info()

    def gz(name: str) -> str:
        if n_hosts > 1:
            # per-process output shard
            root, dot, ext = name.rpartition(".")
            name = f"{root}.p{pid}{dot}{ext}" if dot else f"{name}.p{pid}"
        if ctx.cfg.filter.compress_output and not name.endswith(".gz"):
            return name + ".gz"
        return name

    clean1 = wd.stage_file("cleandata", gz(cleanq1 or "clean.1.fq"))
    clean2 = (
        wd.stage_file("cleandata", gz(cleanq2 or "clean.2.fq"))
        if fastq2 else None
    )
    res = filter_reads(ctx.cfg.filter, fastq1, clean1, fastq2, clean2,
                       host_shard=(pid, n_hosts), device=ctx.device)
    wd.write_manifest("cleandata", {
        "inputs": [fastq1] + ([fastq2] if fastq2 else []),
        "outputs": [res.clean1] + ([res.clean2] if res.clean2 else []),
        "reads_in": res.reads_in, "reads_kept": res.reads_kept,
        "bases_kept": res.bases_kept,
    })
    return res


def run_assemble(ctx: PipelineContext, clean1: str, clean2: Optional[str] = None,
                 inputs_sharded: bool = False) -> str:
    """``inputs_sharded``: the clean files are already this process's shard
    — don't split them again."""
    from .stages.assemble import assemble
    from .stages.scaffold import scaffold_contigs

    wd = ctx.workdir
    out = wd.stage_file("assemble", "contigs.fa")
    assemble(ctx.cfg.assemble, clean1, clean2, out,
             max_read_len=ctx.cfg.filter.max_read_len,
             host_shard=(0, 1) if inputs_sharded else None,
             spill_dir=wd.stage_dir("assemble"), device=ctx.device)
    if not ctx.cfg.assemble.disable_scaffolding and clean2:
        out2 = wd.stage_file("assemble", "scaffolds.fa")
        scaffold_contigs(ctx.cfg.assemble, out, clean1, clean2, out2,
                         device=ctx.device)
        out = out2
    wd.write_manifest("assemble", {"inputs": [clean1, clean2], "outputs": [out]})
    return out
