"""Annotate stage: picked mitoscaffolds → gene locations (locs.json) +
annotated CDS/RNA FASTAs.

Port of mitoflex_tpu/stages/annotate.py, itself a re-implementation of the
original pipeline's annotation stage (annotation/annotation.py:56-273, call
stack SURVEY.md §3D). Every search runs on the run's ``device`` (``None`` is
the card, see device.resolve_device); with a ``mesh`` (parallel/mesh.py)
the translated search, genewise and the profile-HMM rescue shard over it.
``AnnotateResult.walls`` holds
the seconds spent in the translated search, genewise, the tRNA search and
the rRNA search, each timed by its span (utils/trace.py).

1. circular-overlap trim of a single scaffold (fix_circular, :261-273);
2. translated search of the clade protein DB vs the genome (device SW)
   with blast_to_csv gates and the wash algebra;
3. optional strand-majority genome redirection (:92-100);
4. genewise-equivalent refinement, batched over ALL washed hits in one
   device call (ops/genewise.py) producing wise_cover/shift/min_start/
   max_end — then a second wash (mut_plus=False) like the reference;
5. species vote: best-scoring taxon per PCG, majority wins (:111-131);
6. optional start/stop-codon relocation (reloc_genes,
   annotation_tookit.py:317-360);
7. missing-PCG rescue via the profile-HMM scan (:153-162);
8. tRNA search (CM filter scan + CYK + anticodon walk) and rRNA search
   (models/cmsearch.py);
9. locs.json ``{gene: [start, end, type(0=PCG,1=tRNA,2=rRNA), contig,
   strand]}`` plus {prefix}.annotated.cds.fa / .rna.fa with the same
   description contract (gene=/start=/end=/from=/strand=).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..config import AnnotateConfig
from ..convert import host, to_device
from ..device import resolve_device
from ..io import encoding
from ..io.fasta import FastaRecord, write_fasta
from ..models import blast as blast_models
from ..models import cmsearch, codon
from ..models.profiles import ProfileSet
from ..models.proteindb import ProteinRecord, parse_protein_id
from ..ops import genewise as genewise_ops
from ..ops.overlap import check_circular
from ..parallel import mesh as mesh_mod
from ..utils import trace
from ..utils.helper import timed
from ..utils.logger import logger


@dataclass
class AnnotateResult:
    locs: Dict[str, tuple]
    species: Optional[str]
    cds_records: List[FastaRecord]
    rna_records: List[FastaRecord]
    missing_trnas: List[str]
    wise_frame: pd.DataFrame
    circular: bool = False   # genome was circular and trimmed (annotation.py:220-221)
    walls: Dict[str, float] = field(default_factory=dict)
    path: str = ""  # locs.json, once the pipeline has written it


def fix_circular(records: List[FastaRecord]) -> Tuple[List[FastaRecord], bool]:
    """Trim the duplicated circular overlap of a single scaffold
    (annotation.py:261-273)."""
    if len(records) != 1:
        return records, False
    info, rec = next(iter(check_circular(records)))
    if info is None:
        return records, False
    f_start, f_end, _ = info
    seq = rec.seq[f_start : len(rec.seq) - 500 + f_end]
    logger.info(
        f"fix_circular: overlap at {f_start} len {info[2]}; trimmed to {len(seq)} bp"
    )
    return [FastaRecord(rec.id, seq, dict(rec.attrs, len=len(seq)))], True


def _genewise_refine(
    washed: pd.DataFrame,
    genome: Dict[str, FastaRecord],
    db: Dict[str, ProteinRecord],
    table_id: int,
    device=None,
    mesh=None,
) -> pd.DataFrame:
    """Batched genewise over every washed hit (reference runs wise2
    serially per hit, annotation_tookit.py:264-311); the hits shard over a
    mesh of more than one shard (parallel.mesh.genewise_align_sharded)."""
    rows = list(washed.itertuples())
    if not rows:
        return washed
    q_rows, t_rows, metas = [], [], []
    for r in rows:
        prot = db[r.qseq]
        contig = genome[r.sseq]
        ext_start = max(int(r.sstart) - 30, 0)       # 0-based inclusive
        ext_end = min(int(r.send) + 30, len(contig.seq))
        window = contig.codes[ext_start:ext_end]
        if not r.plus:
            window = np.asarray(encoding.revcomp(window))
        q_rows.append(prot.aa_codes)
        t_rows.append(window)
        metas.append((r.Index, ext_start, ext_end, len(contig.seq), bool(r.plus), prot))

    # rows padded to the longest only: the reference's power-of-two batch
    # and widths bounded recompiles, and padding changes no alignment
    Lq = max(len(q) for q in q_rows)
    Lt = max(len(t) for t in t_rows)
    B = len(q_rows)
    qa = np.full((B, Lq), codon.X_CODE, np.int8)
    ta = np.full((B, Lt), 4, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (q, t) in enumerate(zip(q_rows, t_rows)):
        qa[i, : len(q)] = q
        ta[i, : len(t)] = t
        ql[i], tl[i] = len(q), len(t)
    aa = genewise_ops.translate_windows(ta, table_id)
    if mesh is not None and mesh.size > 1:
        hits = mesh_mod.genewise_align_sharded(mesh, qa, ql, aa, tl, codon.blosum62())
    else:
        dev = resolve_device(device)
        hits = genewise_ops.genewise_align(
            to_device(qa, dev), to_device(ql, dev), to_device(aa, dev),
            to_device(tl, dev), codon.blosum62(),
        )
    qf, qt = host(hits.q_from), host(hits.q_to)
    tf, tt = host(hits.t_from), host(hits.t_to)
    nsh = host(hits.n_shift)

    out = washed.copy()
    out["wise_cover"] = np.nan
    out["wise_shift"] = np.nan
    out["wise_min_start"] = np.nan
    out["wise_max_end"] = np.nan
    for i, (idx, ext_start, ext_end, clen, plus, prot) in enumerate(metas):
        cover = (int(qt[i]) - int(qf[i]) + 1) / max(prot.length, 1)
        # t coords are codon-start/codon-end in the oriented window; map
        # back to 1-based contig plus-strand coordinates
        w_from, w_to = int(tf[i]), int(tt[i])
        if plus:
            g_start = ext_start + w_from + 1
            g_end = ext_start + w_to + 1
        else:
            wlen = ext_end - ext_start
            g_start = ext_start + (wlen - 1 - w_from) + 1  # start > end
            g_end = ext_start + (wlen - 1 - w_to) + 1
        out.loc[idx, "wise_cover"] = cover
        out.loc[idx, "wise_shift"] = int(nsh[i])
        out.loc[idx, "wise_min_start"] = g_start
        out.loc[idx, "wise_max_end"] = g_end
    return out


def reloc_genes(
    wises: pd.DataFrame, genome: Dict[str, FastaRecord], table_id: int
) -> pd.DataFrame:
    """Start/stop-codon refinement (annotation_tookit.py:317-360): look for
    the first in-frame stop to set the real end, and a start codon near the
    alignment start."""
    gc = codon.get_code(table_id)
    out = wises.copy()
    for idx, wise in wises.iterrows():
        contig = genome[wise.sseq]
        lo, hi = int(min(wise.wise_min_start, wise.wise_max_end)), int(
            max(wise.wise_min_start, wise.wise_max_end)
        )
        ext_lo = max(lo - 30, 0)
        ext_hi = min(hi + 30, len(contig.seq))
        seg = contig.codes[ext_lo:ext_hi]
        if not wise.plus:
            seg = np.asarray(encoding.revcomp(seg))
        usable = len(seg) - len(seg) % 3
        pep = gc.translate_codes(seg[:usable])
        pep_str = codon.aa_decode(pep)
        start_real = end_real = -1
        stop_at = pep_str.find("*")
        if stop_at != -1:
            end_off = (stop_at + 1) * 3  # include the stop codon
            end_real = (ext_lo + end_off) if wise.plus else (ext_hi - end_off + 1)
        # start: first start codon in the first 11 codons
        for ci in range(min(11, usable // 3)):
            tri = seg[ci * 3 : ci * 3 + 3]
            if (tri < 4).all():
                cstr = encoding.decode(tri)
                if cstr in gc.starts:
                    start_real = (ext_lo + ci * 3 + 1) if wise.plus else (ext_hi - ci * 3)
                    break
        if wise.plus:
            if start_real != -1:
                out.loc[idx, "wise_min_start"] = start_real
            if end_real != -1:
                out.loc[idx, "wise_max_end"] = end_real
        else:
            if start_real != -1:
                out.loc[idx, "wise_min_start"] = start_real
            if end_real != -1:
                out.loc[idx, "wise_max_end"] = end_real
    return out


def redirect_genome(
    records: List[FastaRecord], blast_frame: pd.DataFrame
) -> Tuple[List[FastaRecord], bool]:
    """Flip sequences where most hits are on the minus strand
    (annotation_tookit.py:363-377)."""
    out = []
    flipped = False
    for rec in records:
        sub = blast_frame[blast_frame.sseq == rec.id]
        if len(sub) and (sub.sstart > sub.send).sum() >= len(sub) / 2:
            out.append(FastaRecord(rec.id, encoding.revcomp_str(rec.seq), dict(rec.attrs)))
            flipped = True
        else:
            out.append(rec)
    return out, flipped


@timed()
def annotate(
    cfg: AnnotateConfig,
    records: List[FastaRecord],
    profiles: ProfileSet,
    clade: str,
    gene_code: Optional[int] = None,
    basedir: Optional[str] = None,
    prefix: str = "mitoflex",
    device=None,
    mesh=None,
) -> AnnotateResult:
    dev = resolve_device(device)
    walls = {"tblastn": 0.0, "genewise": 0.0, "trna": 0.0, "rrna": 0.0}
    table_id = gene_code or cfg.genetic_code or profiles.genetic_code(clade)
    records, circular = fix_circular(records) if cfg.trim_circular else (records, False)
    if circular:
        logger.info("The final mitogenome is circular and trimmed.")
    genome = {r.id: r for r in records}

    db_records = (
        profiles.merged_protein_db() if cfg.wider_taxa else profiles.protein_db(clade)
    )
    db = {r.id: r for r in db_records}

    # the reference's annotate entry passes score=5 into blast_to_csv
    # (annotation.py:56-58,84), laxer than findmitoscaf's default of 25
    with trace.span("annotate.tblastn", into=(walls, "tblastn")):
        frame = blast_models.tblastn(db_records, records, table_id, device=dev, mesh=mesh)
    frame = blast_models.blast_filter(frame, cfg.min_identity, 5.0, cfg.qcover_ratio)
    if frame.empty:
        raise RuntimeError(
            "Empty blast frame while annotating; please check the picked fasta."
        )
    washed = blast_models.wash_blast_results(frame, cfg.overlap_ratio)

    if cfg.redirection:
        records, flipped = redirect_genome(records, frame)
        if flipped:
            logger.info("annotate: genome reversed; re-running the translated search")
            genome = {r.id: r for r in records}
            with trace.span("annotate.tblastn", into=(walls, "tblastn")):
                frame = blast_models.tblastn(db_records, records, table_id, device=dev,
                                             mesh=mesh)
            frame = blast_models.blast_filter(frame, cfg.min_identity, 5.0, cfg.qcover_ratio)
            washed = blast_models.wash_blast_results(frame, cfg.overlap_ratio)

    with trace.span("annotate.genewise", into=(walls, "genewise")):
        wise_frame = _genewise_refine(washed, genome, db, table_id, device=dev, mesh=mesh)
    wise_frame = blast_models.wash_blast_results(wise_frame, cfg.overlap_ratio, mut_plus=False)

    # species vote (annotation.py:111-131)
    taxa_data: Dict[str, Tuple[str, float]] = {}
    for _, row in wise_frame.iterrows():
        meta = parse_protein_id(str(row.qseq))
        pcg, taxon = meta["gene"], meta.get("taxon", "?")
        if pcg not in taxa_data or taxa_data[pcg][1] < float(row.score):
            taxa_data[pcg] = (taxon, float(row.score))
    votes: Dict[str, int] = {}
    for taxon, _ in taxa_data.values():
        votes[taxon] = votes.get(taxon, 0) + 1
    species = max(votes, key=votes.get) if votes else None
    if species:
        logger.info(f"annotate: most possible species: {species}")

    if cfg.reloc_genes:
        wise_frame = reloc_genes(wise_frame, genome, table_id)

    required_cds = profiles.required_cds(clade)
    cds_found = [parse_protein_id(str(r.qseq))["gene"] for _, r in wise_frame.iterrows()]
    cds_notfound = [g for g in required_cds if g not in cds_found]
    logger.info(f"annotate: PCGs found: {sorted(set(cds_found))}")

    hmmer_frame = None
    if cds_notfound and cfg.use_hmmer:
        logger.warn(f"annotate: PCGs {cds_notfound} missing; trying profile-HMM rescue")
        from ..models import nhmmer

        hmms = [m for m in profiles.cds_hmms(clade) if m.name in cds_notfound]
        with trace.span("annotate.rescue"):
            hf = nhmmer.nhmmer_search(records, hmms, device=dev, mesh=mesh,
                                      e_threshold=cfg.hmmer_e,
                                      score_threshold=cfg.hmmer_score)
        hmmer_frame = hf if not hf.empty else None
    elif cds_notfound:
        logger.warn(f"annotate: expected PCGs {cds_notfound} not found")

    # ---- RNAs ----
    try:
        trna_models = profiles.trna_cms()
    except FileNotFoundError:
        trna_models = {}
    with trace.span("annotate.trna", into=(walls, "trna")):
        query_dict, missing_trna = (
            cmsearch.trna_search(records, trna_models, table_id, 0.01,
                                 overlap_cutoff=40, device=dev)
            if trna_models else ({}, [])
        )
    logger.info(f"annotate: tRNAs found: {list(query_dict)}")
    if missing_trna:
        logger.warn(f"annotate: missing tRNAs: {missing_trna}")

    try:
        rrna_models = profiles.rrna_cms()
    except FileNotFoundError:
        rrna_models = {}
    with trace.span("annotate.rrna", into=(walls, "rrna")):
        r12, r16 = (cmsearch.rrna_search(records, rrna_models, 0.01, device=dev)
                    if rrna_models else (None, None))
    if not r12:
        logger.warn("annotate: 12s rRNA not found")
    if not r16:
        logger.warn("annotate: 16s rRNA not found")

    # ---- emit ----
    locs: Dict[str, tuple] = {}
    cds_records: List[FastaRecord] = []
    for _, row in wise_frame.iterrows():
        gene = parse_protein_id(str(row.qseq))["gene"]
        if gene in locs:
            count = sum(x.startswith(gene) for x in locs)
            gene = f"{gene}{'_' if count > 0 else ''}{count}"
        start = int(min(row.wise_min_start, row.wise_max_end))
        end = int(max(row.wise_min_start, row.wise_max_end))
        strand = "+" if row.plus else "-"
        frag = genome[str(row.sseq)].seq[start - 1 : end]
        cds_records.append(
            FastaRecord(
                genome[str(row.sseq)].id, frag,
                {"gene": gene, "start": start, "end": end,
                 "from": str(row.sseq), "strand": strand},
            )
        )
        locs[gene] = (start, end, 0, str(row.sseq), strand)

    if hmmer_frame is not None:
        for _, row in hmmer_frame.iterrows():
            start = int(min(row.alifrom, row.alito))
            end = int(max(row.alifrom, row.alito))
            frag = genome[str(row.target)].seq[start - 1 : end]
            cds_records.append(
                FastaRecord(
                    str(row.target), frag,
                    {"gene": str(row["query"]), "start": start, "end": end,
                     "from": str(row.target), "strand": row.strand},
                )
            )
            locs[str(row["query"])] = (start, end, 0, str(row.target), str(row.strand))

    rna_records: List[FastaRecord] = []
    for key, hit in query_dict.items():
        start, end = hit.span()
        frag = genome[hit.sequence].seq[start - 1 : end]
        rna_records.append(
            FastaRecord(hit.sequence, frag,
                        {"gene": f"trn{key}", "start": start, "end": end}))
        locs[f"trn{key}"] = (start, end, 1, hit.sequence, "+" if hit.plus else "-")
    for name, hit in (("rrnS", r12), ("rrnL", r16)):
        if hit is None:
            continue
        start, end = hit.span()
        logger.info(f"annotate: {name} found from {start} to {end}")
        frag = genome[hit.sequence].seq[start - 1 : end]
        rna_records.append(
            FastaRecord(hit.sequence, frag,
                        {"gene": name, "start": start, "end": end}))
        locs[name] = (start, end, 2, hit.sequence, "+" if hit.plus else "-")

    if basedir:
        os.makedirs(basedir, exist_ok=True)
        # debugging artifacts matching the reference's temp files
        # ({prefix}.wise.csv, annotation_tookit.py:313)
        wise_frame.to_csv(os.path.join(basedir, f"{prefix}.wise.csv"), index=False)
        with open(os.path.join(basedir, "locs.json"), "w") as f:
            json.dump(locs, f, indent=4, separators=(",", ": "))
        write_fasta(cds_records, os.path.join(basedir, f"{prefix}.annotated.cds.fa"))
        write_fasta(rna_records, os.path.join(basedir, f"{prefix}.annotated.rna.fa"))

    return AnnotateResult(locs, species, cds_records, rna_records,
                          missing_trna, wise_frame, circular, walls)
