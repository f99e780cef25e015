"""findmitoscaf stage: pick the mitochondrial scaffold(s) out of assembly.

Port of mitoflex_tpu/stages/findmitoscaf.py. The selection logic is the
reference's host code (copied: the reference module imports the
jax-importing search modules); the searches run on the caller's ``device``
through the port's nhmmer (ops/phmm.py Viterbi) and blast (ops/sw.py
Smith-Waterman) modules:

1. optional global merge of overlapping contigs (merge_method == 0);
2. profile-HMM scan of all contigs against the clade's PCG models;
3. taxonomy filter: tblastn of the contigs against the clade's protein DB,
   washed, each contig kept if a hit's taxon matches the required taxa;
4. abundance split at ``multi >= min_abundance``;
5. greedy PCG cover (``greedy_pcg_cover``);
6. merge_method 1: partial merge plus the additional check run
   (merge_method 2) that drops sequences which lost their genes;
7. circularity re-mark of a single scaffold (flag=3), and the optional
   split_two bridge sequence.

The result also carries the wall seconds of the searches (``walls``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import pandas as pd

from ..config import SearchConfig
from ..io.fasta import FastaRecord, write_fasta
from ..models.profiles import ProfileSet
from ..models.proteindb import parse_protein_id
from ..models.taxonomy import Taxonomy
from ..ops.overlap import check_circular
from ..utils.helper import timed
from ..utils.logger import logger

from ..models import blast as blast_models
from ..models import nhmmer
from . import merge as merge_stage


@dataclass
class FindMitoResult:
    picked: List[FastaRecord]
    hmm_frame: pd.DataFrame
    selected_candidates: Dict[str, object]
    found_pcgs: List[str]
    missing_pcgs: List[str]
    # wall seconds by part: "nhmmer" (profile search), "blast" (tblastn and
    # blastn with their Smith-Waterman, merge algebra included), "total"
    walls: Dict[str, float] = field(default_factory=dict)
    path: str = ""  # the picked FASTA, once the pipeline has written it


def taxonomy_filter(
    contigs: Sequence[FastaRecord],
    hmm_frame: pd.DataFrame,
    profiles: ProfileSet,
    taxonomy: Taxonomy,
    required_taxa: str,
    gene_code: int,
    relaxing: int = 0,
    device=None,
) -> pd.DataFrame:
    """reference filter_taxanomy (findmitoscaf.py:392-436)."""
    db = profiles.merged_protein_db()
    frame = blast_models.tblastn(db, list(contigs), gene_code, device=device)
    frame = blast_models.blast_filter(frame)
    if frame.empty:
        logger.warn("taxonomy_filter: no tblastn hits; keeping nothing")
        return hmm_frame[hmm_frame.target.isin(set())]
    washed = blast_models.wash_blast_results(frame)
    to_save = []
    for sseq, sub in washed.groupby("sseq"):
        for _, row in sub.iterrows():
            taxon = parse_protein_id(str(row.qseq)).get("taxon", "")
            if taxonomy.matches_required(taxon, required_taxa, relaxing):
                to_save.append(sseq)
                break
    filtered = hmm_frame[hmm_frame["target"].isin(to_save)]
    logger.info(
        f"taxonomy_filter: {len(filtered)} hmm records kept after taxa filtering"
    )
    return filtered


def greedy_pcg_cover(
    hmm_frame: pd.DataFrame,
    contig_map: Dict[str, FastaRecord],
    contig_multis: Dict[str, float],
    required_cds: Dict[str, int],
    full_ratio: float = 0.95,
    min_valid_ratio: float = 0.3,
) -> Tuple[Dict[str, object], List[str]]:
    """reference findmitoscaf.py:198-329. Returns (selected_candidates,
    selected_ids)."""
    candidates: Dict[str, Dict[str, tuple]] = {}
    sequence_completeness: Dict[str, List[str]] = {}

    for _, row in hmm_frame.iterrows():
        query = str(row["query"])
        index = str(row["target"])
        if query not in required_cds or index not in contig_map:
            continue
        score = float(row["score"])
        align_start = int(row["alifrom"])
        align_end = int(row["alito"])
        align_length = abs(align_start - align_end) + 1
        query_start = int(row["hmmfrom"])
        query_to = int(row["hmmto"])

        complete = align_length >= required_cds[query] * full_ratio
        if not complete:
            missing_length = required_cds[query] - align_length
            lo, hi = sorted((align_start, align_end))
            isolated = (
                lo > missing_length
                and len(contig_map[index].seq) - hi > missing_length
            )
            complete = complete or isolated
            if complete and align_length <= required_cds[query] * min_valid_ratio:
                logger.warn(
                    f"ignoring {query} on {index}: aligned {align_length} below "
                    f"valid ratio of {required_cds[query]}"
                )
                continue

        sequence_completeness.setdefault(index, [])
        if complete:
            sequence_completeness[index].append(query)
        candidates.setdefault(index, {})[query] = (
            score * contig_multis.get(index, 1.0), query_start, query_to, complete,
        )

    flat = sorted(candidates.items(), key=lambda x: len(x[1]), reverse=True)
    selected: Dict[str, object] = {x: None for x in required_cds}
    fulled: List[str] = []

    for index, mapping in flat:
        completed = [g for g in mapping if mapping[g][3]]
        incompleted = [g for g in mapping if not mapping[g][3]]
        if any(selected[g] is not None and not isinstance(selected[g], list) for g in completed):
            continue
        for g in completed:
            selected[g] = index
            fulled.append(g)
        for g in incompleted:
            if selected[g] is None:
                selected[g] = [(index, *mapping[g][:-1])]
            elif isinstance(selected[g], list):
                selected[g].append((index, *mapping[g][:-1]))

    # fragment recovery with interval conflict sweep (reference :273-329)
    for gene in [g for g in selected if selected[g] is None or isinstance(selected[g], list)]:
        for index, mapping in candidates.items():
            if gene not in mapping:
                continue
            if any(g in fulled for g in sequence_completeness.get(index, [])):
                continue
            if selected[gene] is None:
                selected[gene] = []
            entry = (index, *mapping[gene][:-1])
            if entry not in selected[gene]:
                selected[gene].append(entry)

        if isinstance(selected[gene], list) and selected[gene]:
            gene_map = []
            for pos in selected[gene]:
                gene_map.append((pos[2], (pos[0], pos[1])))
                gene_map.append((pos[3], (pos[0], pos[1])))
            gene_map.sort(key=lambda x: x[0])
            gene_map = [x[1] for x in gene_map]

            def overlapping():
                for i in range(0, len(gene_map) - 1, 2):
                    left = gene_map[i]
                    right = gene_map[i + 1]
                    if left[0] != right[0]:
                        if left[1] < right[1]:
                            gene_map.remove(left)
                            gene_map.remove(left)
                        else:
                            gene_map.remove(right)
                            gene_map.remove(right)
                        return True
                return False

            while overlapping():
                pass
            selected[gene] = list({x[0] for x in gene_map})

    selected_ids: List[str] = []
    for v in selected.values():
        if v is None:
            continue
        if isinstance(v, list):
            selected_ids.extend(x if isinstance(x, str) else x[0] for x in v)
        else:
            selected_ids.append(v)
    return selected, sorted(set(selected_ids))


def _write_artifacts(basedir, prefix, **named) -> None:
    """Stage debugging artifacts matching the reference's temp files
    ({prefix}.hmm.filtered.fa, .taxa.csv, .abundance.high/low.fa,
    .candidates.json — findmitoscaf.py:142,169,185,330)."""
    if not basedir:
        return
    os.makedirs(basedir, exist_ok=True)
    for name, value in named.items():
        path = os.path.join(basedir, f"{prefix}.{name}")
        if name.endswith(".json"):
            with open(path, "w") as f:
                json.dump(value, f, sort_keys=True, indent=4,
                          separators=(", ", ": "), default=str)
        elif name.endswith(".csv"):
            value.to_csv(path, index=False)
        elif name.endswith(".fa"):
            write_fasta(value, path)


@timed()
def findmitoscaf(
    cfg: SearchConfig,
    contigs: List[FastaRecord],
    profiles: ProfileSet,
    clade: str,
    taxonomy: Optional[Taxonomy] = None,
    gene_code: int = 5,
    max_contig_len: int = 20000,
    basedir: Optional[str] = None,
    prefix: str = "mitoflex",
    device=None,
    _recurse: bool = False,
) -> FindMitoResult:
    t_start = time.perf_counter()
    walls = {"nhmmer": 0.0, "blast": 0.0}

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            walls[name] += time.perf_counter() - t0

    if cfg.merge_method == 0 and not _recurse:
        contigs, n = part("blast", merge_stage.merge_sequences,
                          contigs, cfg.merge_overlap, cfg.merge_start,
                          max_contig_len, device=device)
        logger.info(f"findmitoscaf: merged {n} sequences (global method)")

    hmms = profiles.cds_hmms(clade)
    hmm_frame = part("nhmmer", nhmmer.nhmmer_search, contigs, hmms,
                     e_threshold=1e-3, score_threshold=5.0, device=device)
    if hmm_frame.empty:
        raise RuntimeError(
            "The result from nhmmer is empty! Please check if the data is "
            "unqualified, or a wrong clade is given."
        )
    hmm_targets = set(hmm_frame.target)
    hmm_contigs = [c for c in contigs if c.id in hmm_targets]
    if not _recurse:
        _write_artifacts(basedir, prefix, **{"hmm.filtered.fa": hmm_contigs})

    if not cfg.disable_taxa and taxonomy is not None:
        try:
            hmm_frame = part(
                "blast", taxonomy_filter, hmm_contigs, hmm_frame, profiles,
                taxonomy, cfg.required_taxa, gene_code, cfg.taxa_tolerance,
                device=device,
            )
        except FileNotFoundError:
            logger.warn("findmitoscaf: no protein DB for taxa filter; skipping")
    else:
        logger.warn("Skipping taxonomy filtering.")

    hmm_targets = set(hmm_frame.target)
    contig_data = [c for c in hmm_contigs if c.id in hmm_targets]
    if not contig_data:
        raise RuntimeError(
            "The result from nhmmer/taxonomy filtering is empty!"
        )

    # abundance split (reference :164-191)
    high, low = [], []
    contig_multis: Dict[str, float] = {}
    for c in contig_data:
        if c.multi >= cfg.min_abundance:
            high.append(c)
            contig_multis[c.id] = c.multi
        else:
            low.append(c)
            hmm_frame = hmm_frame[hmm_frame.target != c.id]
    logger.info(
        f"findmitoscaf: {len(high)} high / {len(low)} low abundance at multi={cfg.min_abundance}"
    )
    if not _recurse:
        _write_artifacts(
            basedir, prefix,
            **{"abundance.high.fa": high, "abundance.low.fa": low,
               "taxa.csv": hmm_frame},
        )
    if not high:
        raise RuntimeError("No contig passed the abundance filter!")

    contig_map = {c.id: c for c in high}
    required_cds = profiles.required_cds(clade)
    selected, selected_ids = greedy_pcg_cover(
        hmm_frame, contig_map, contig_multis, required_cds,
        cfg.full_ratio, cfg.min_valid_ratio,
    )
    picked = [contig_map[i] for i in selected_ids if i in contig_map]
    if not _recurse:
        _write_artifacts(basedir, prefix, **{"candidates.json": selected})
    found = [g for g in required_cds if selected.get(g)]
    missing = [g for g in required_cds if g not in found]
    logger.info(f"findmitoscaf: PCGs found: {found}")
    if missing:
        logger.warn(f"findmitoscaf: missing PCGs: {missing} (may be rescued in annotation)")

    if cfg.merge_method == 1 and not _recurse:
        picked, _, n = part(
            "blast", merge_stage.merge_partial,
            picked, [c for c in contigs if c.id not in {p.id for p in picked}],
            cfg.merge_overlap, cfg.merge_start, max_contig_len, device=device,
        )
        logger.info(f"findmitoscaf: merged {n} sequences (partial method)")
        if cfg.additional_check:
            logger.info("findmitoscaf: additional check run after merging")
            sub_cfg = SearchConfig(**{**cfg.__dict__, "merge_method": 2, "split_two": False})
            sub = findmitoscaf(
                sub_cfg, picked, profiles, clade, taxonomy, gene_code,
                max_contig_len, device=device, _recurse=True,
            )
            for name in walls:
                walls[name] += sub.walls[name]
            picked = sub.picked
            selected, found, missing = sub.selected_candidates, sub.found_pcgs, sub.missing_pcgs
            hmm_frame = sub.hmm_frame
    elif cfg.merge_method == 2 and not _recurse:
        picked, n = part("blast", merge_stage.merge_sequences,
                         picked, cfg.merge_overlap, cfg.merge_start,
                         max_contig_len, device=device)
        logger.info(f"findmitoscaf: merged {n} sequences (global method)")

    # circularity re-mark (reference remark_circular:593-602)
    if len(picked) == 1:
        for info, rec in check_circular(picked):
            if info is not None:
                picked = [rec.with_attrs(flag=3)]
                logger.info("findmitoscaf: picked scaffold marked circular (flag=3)")

    # split_two bridge (reference :366-375, implementing the documented
    # intent — the reference overwrites seq_addi with its id by mistake)
    if cfg.split_two and len(picked) == 1 and picked[0].flag == 3:
        base = picked[0]
        bridge = base.seq[-1000:] + base.seq[:1000]
        picked = [base, FastaRecord(
            base.id + "_addi", bridge,
            {"flag": 0, "multi": base.multi, "len": len(bridge)},
        )]

    walls["total"] = time.perf_counter() - t_start
    return FindMitoResult(picked, hmm_frame, selected, found, missing, walls)
