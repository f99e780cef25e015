"""Pipeline orchestrator for the ported stages (filter, assemble,
findmitoscaf, annotate).

Port of mitoflex_tpu/pipeline.py: each stage reads and writes files under
``<workname>.temp/<stage>/`` with a manifest, so a stage can be re-run on
its own. The context carries the run's ``torch.device``, which every stage
receives explicitly. visualize, ``run_all`` and ``run_bim`` are not ported
yet (ROADMAP).
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Optional

import torch

from .config import PipelineConfig
from .io import fasta, fastq
from .models.profiles import ProfileSet, get_profiles
from .models.taxonomy import Taxonomy, load_taxonomy
from .utils.logger import logger
from .utils.workdir import WorkDir

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

    @property
    def gene_code(self) -> int:
        cfg = self.cfg.annotate
        if cfg.genetic_code:
            return cfg.genetic_code
        if self.profiles is not None:
            try:
                return self.profiles.genetic_code(cfg.clade)
            except (FileNotFoundError, KeyError):
                pass
        return 5


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


def run_findmitoscaf(
    ctx: PipelineContext,
    contigs_path: str,
    clean1: Optional[str] = None,
    clean2: Optional[str] = None,
    from_megahit: bool = True,
):
    """Pick the mitochondrial scaffolds into ``{workname}.picked.fa`` (the
    reference's names and manifest); returns the stage's ``FindMitoResult``
    with ``path`` set to that file.

    ``from_megahit=False`` is the standalone entry: the contigs carry no
    depth tags, so they are gated by the assembler's min/max length and
    their depth comes from remapping the clean reads."""
    from .ops import mapper
    from .stages.findmitoscaf import findmitoscaf

    wd = ctx.workdir
    records = fasta.load_fasta(contigs_path)
    if not from_megahit and not clean1 and clean2:
        clean1, clean2 = clean2, clean1
    if not from_megahit and not clean1:
        raise RuntimeError("At least one fastq file should be specified!")
    if not from_megahit and clean1:
        lo, hi = ctx.cfg.assemble.min_length, ctx.cfg.assemble.max_length
        records = [r for r in records if lo <= len(r.seq) <= hi]

        def batches():
            for path in (clean1, clean2):
                if path:
                    yield from fastq.read_batches(path, 8192, ctx.cfg.filter.max_read_len)

        _, means, _, _ = mapper.coverage_of_reads(records, batches(), device=ctx.device)
        records = [r.with_attrs(flag=1, multi=round(means.get(r.id, 0.0), 2))
                   for r in records]
    res = findmitoscaf(
        ctx.cfg.search, records, ctx.profiles, ctx.cfg.annotate.clade,
        taxonomy=ctx.taxonomy, gene_code=ctx.gene_code,
        max_contig_len=ctx.cfg.annotate.max_contig_length,
        basedir=wd.stage_dir("findmitoscaf"), prefix=ctx.cfg.run.workname,
        device=ctx.device,
    )
    name = f"{ctx.cfg.run.workname}.picked.fa"
    out = wd.stage_file("findmitoscaf", name)
    fasta.write_fasta(res.picked, out)
    shutil.copy(out, wd.result_file(name))
    wd.write_manifest("findmitoscaf", {
        "inputs": [contigs_path], "outputs": [out],
        "found_pcgs": res.found_pcgs, "missing_pcgs": res.missing_pcgs,
    })
    res.path = out
    return res


def run_annotate(ctx: PipelineContext, picked_path: str):
    """Annotate the picked scaffolds: ``locs.json``,
    ``{workname}.annotated.cds.fa``, ``{workname}.annotated.rna.fa`` and
    ``{workname}.wise.csv`` under the ``annotation`` stage directory (the
    first three copied to the results, as the reference does); returns the
    stage's ``AnnotateResult`` with ``path`` set to ``locs.json``."""
    from .stages.annotate import annotate

    wd = ctx.workdir
    records = fasta.load_fasta(picked_path)
    basedir = wd.stage_dir("annotation")
    res = annotate(
        ctx.cfg.annotate, records, ctx.profiles, ctx.cfg.annotate.clade,
        gene_code=ctx.gene_code, basedir=basedir, prefix=ctx.cfg.run.workname,
        device=ctx.device,
    )
    for name in ("locs.json", f"{ctx.cfg.run.workname}.annotated.cds.fa",
                 f"{ctx.cfg.run.workname}.annotated.rna.fa"):
        src = os.path.join(basedir, name)
        if os.path.exists(src):
            shutil.copy(src, wd.result_file(name))
    wd.write_manifest("annotation", {
        "inputs": [picked_path],
        "outputs": [os.path.join(basedir, "locs.json")],
        "species": res.species,
        "circular": res.circular,
    })
    res.path = os.path.join(basedir, "locs.json")
    return res
