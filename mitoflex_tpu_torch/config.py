"""Typed configuration for the whole pipeline.

Replaces three mechanisms of the reference with one typed system
(SURVEY.md §5 "Config/flag system"):

1. decorator-declared CLI args + per-group "regulator" validation callbacks
   (reference utility/parser.py:49-452, arguments.py:50-614),
2. executable-Python config files merged over CLI (utility/parser.py:374-389),
3. auto-vivifying expert knobs in configurations.py (whose attribute typos
   silently become truthy — a quirk we deliberately do NOT replicate;
   SURVEY.md §7 "Known reference quirks").

Here every knob is a field on a frozen-by-convention dataclass; unknown keys
raise. Defaults mirror the reference's CLI defaults (arguments.py) and
expert knobs (configurations.py) so behavior matches out of the box.
``--generate-config`` / ``--config`` parity is provided by
:func:`generate_config` / :func:`load_config_file`.

Reference knobs with no TPU analog (intentionally absent):
- assemble.max_mem_percent / external_temp — megahit host-memory budgeting
  and tmpfs staging; the engine streams fixed-shape device chunks.
- assemble.disable_acc — CPU-feature (POPCNT) selection; no CPU kernels.
- assemble.one_pass — megahit's 1-pass SdBG build skips the separate
  solid-(k+1)-mer counting stage (assemble_wrapper.py:216); this engine's
  sort-based counting IS the graph build, so there is no second pass to
  skip.
- assemble.max_thread_scaf / show_from_soap — SOAP thread-safety caps; the
  scaffolder is deterministic device+host code.
- universal --threads — accepted by the CLI for compatibility, ignored
  (parallelism is device-count driven).
"""

from __future__ import annotations

import dataclasses
import runpy
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def _parse_int_list(v) -> List[int]:
    if isinstance(v, str):
        return [int(x) for x in v.split(",") if x.strip()]
    return [int(x) for x in v]


@dataclass
class FilterConfig:
    """Read quality filtering (reference arguments.py:225-262 +
    filter/filter_bin/src/main.rs semantics)."""

    deduplication: bool = False      # drop PE duplicates by read-1 hash
    ns_valve: int = 10               # discard read if > this many Ns
    quality_valve: int = 55          # phred+33 char code; bases with qual below are "bad"
    percentage_valve: float = 0.2    # discard read if bad/len >= this
    keep_region: Tuple[int, int] = (0, 0)  # (start, end) trim window, 0,0 = full
    trimming: float = 5.0            # only keep first X Gbp of KEPT reads; 0 = all
    truncate_only: bool = False      # bypass filtering, only truncate
    compress_output: bool = False    # gzip clean fastq (configurations.py:45-48)

    # TPU engine knobs (no reference equivalent)
    batch_reads: int = 65536         # reads per device batch
    max_read_len: int = 256          # pad/bucket bound for read length


@dataclass
class AssembleConfig:
    """Multi-k de Bruijn assembly (reference arguments.py:300-335 +
    configurations.py assemble.*)."""

    kmer_list: List[int] = field(default_factory=lambda: [31, 39, 59, 79, 99, 119, 141])
    depth_list: List[int] = field(default_factory=lambda: [10, 20, 20, 50, 50, 70, 70])
    prune_level: int = 2             # strength of low-depth pruning, 0..3
    prune_depth: int = 2             # drop unitigs with avg kmer depth < this
    insert_size: int = 150           # used in scaffolding
    disable_local: bool = False      # skip local (gap) assembly pass
    local_read_stride: int = 1       # map every Nth read in local (gap)
                                     # assembly; >1 trades end-vote depth
                                     # for wall time on deep libraries
                                     # (votes scale as coverage/stride)
    disable_scaffolding: bool = False
    min_multi: int = 3               # min k-mer multiplicity (configurations.py:61)
    no_mercy: bool = True            # disallow mercy edges (configurations.py:67)
    no_filter: bool = False          # disable inter-iteration depth filter
    filter_keep: int = 0             # keep at least N contigs when filtering
    min_length: int = 200            # contig length window (configurations.py:98-101)
    max_length: int = 20000

    # graph-cleaning schedule — the reference fixes these when invoking
    # megahit_core assemble (assemble_wrapper.py:269-286)
    bubble_level: int = 2            # 0 off, 1 simple, 2 complex-by-iteration
    merge_len: int = 20              # complex-bubble branch bound, x k bases
    merge_similar: float = 0.95      # min branch similarity to pop
    disconnect_ratio: float = 0.1    # weak-link cut vs strongest sibling
    low_local_ratio: float = 0.2     # local low-depth unitig removal

    # TPU engine knobs
    kmer_chunk: int = 1 << 22        # k-mers per device sort chunk
    read_chunk: int = 16384          # reads per counting batch (~3.7M windows
                                     # at L=256 — the measured device sort
                                     # sweet spot; amortizes per-chunk
                                     # dispatch at multi-Gbp scale)
    max_contigs: int = 1 << 16       # static bound on contig table size
    prefilter_reads: bool = False    # at k>kmin, only count reads mapping to
                                     # surviving contigs — a speed knob that
                                     # can ALTER results (measured: dropped
                                     # circularity at a 400x fixture's final
                                     # k). Default off = megahit semantics
                                     # (all reads at every k, reference
                                     # assemble_wrapper.py:298-315)


@dataclass
class SearchConfig:
    """findmitoscaf candidate picking (reference arguments.py:369-407 +
    configurations.py findmitoscaf.*)."""

    disable_taxa: bool = False
    min_abundance: float = 10.0      # high/low abundance split
    required_taxa: str = "Arthropoda"
    taxa_tolerance: int = 0          # 0..6 rank relaxation
    merge_method: int = 1            # 0 global, 1 partial, 2 none
    merge_overlap: int = 50          # min overlap bp for merging
    merge_start: int = 50            # overlap must start within X bp of terminal
    full_ratio: float = 0.95         # aligned/required length to call a PCG "full"
    min_valid_ratio: float = 0.3     # interior alignment ratio to count at all
    additional_check: bool = True    # re-run picking after merging
    split_two: bool = False          # emit start/end-bridging extra sequence


@dataclass
class AnnotateConfig:
    """Annotation (reference arguments.py:495-588 + configurations.py
    annotation.*)."""

    disable_annotation: bool = False
    genetic_code: Optional[int] = None  # None = resolve from clade (profile codes.json)
    clade: str = "Arthropoda"
    species_name: str = "Test sp."
    max_contig_length: int = 20000
    wider_taxa: bool = False         # fall back to the merged Animal protein DB
    use_hmmer: bool = False          # nhmmer rescue of missing PCGs
    hmmer_score: float = 5.0
    hmmer_e: float = 0.005
    reloc_genes: bool = False        # start/stop codon refinement
    trim_circular: bool = True
    redirection: bool = False        # strand-majority genome flip
    overlap_ratio: float = 0.2       # blast-hit wash overlap cutoff
    # tblastn-equivalent filters (reference annotation_tookit.py:146-168)
    min_identity: float = 30.0
    min_score: float = 25.0
    qcover_ratio: float = 0.25


@dataclass
class VisualizeConfig:
    """Circular map rendering (reference visualize/visualize.py +
    configurations.py visualize.*)."""

    disable_visualization: bool = False
    gc_window: int = 50              # GC-content histogram window, bp
    max_depth_reads: int = 0         # cap reads remapped for the depth
                                     # track (0 = all, the reference's
                                     # full bwa remap); large runs can
                                     # sample — depth is a relative ring
    color_cds: str = "#8DD3C7"       # 141,211,199 (configurations.py:178)
    color_trna: str = "#FB8072"      # 251,128,114
    color_rrna: str = "#FDC086"      # 253,192,134


@dataclass
class BimConfig:
    """Iterative bait-map-assemble loop (reference arguments.py:590-614)."""

    max_iteration: int = 20
    iteration_ignore: int = 10
    scaffolding_spare: int = 2
    insert_size_auto: bool = False   # estimate insert size from mapping data


@dataclass
class RuntimeConfig:
    """Run-level knobs (reference 'Universal arguments', arguments.py:90-112)
    plus TPU runtime controls."""

    workname: str = "mitoflex"
    basedir: str = "."
    keep_temp: bool = False
    log_level: int = 2               # INFO
    profile_dir: Optional[str] = None  # path to profile data (HMM/CM/protein DBs)
    taxonomy_dump: Optional[str] = None  # path to an NCBI taxdump dir, optional
    # device topology: None = all local devices, data-parallel
    mesh_shape: Optional[List[int]] = None
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])
    use_tpu: bool = True             # False forces pure-XLA CPU path (tests)


@dataclass
class PipelineConfig:
    run: RuntimeConfig = field(default_factory=RuntimeConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    assemble: AssembleConfig = field(default_factory=AssembleConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    annotate: AnnotateConfig = field(default_factory=AnnotateConfig)
    visualize: VisualizeConfig = field(default_factory=VisualizeConfig)
    bim: BimConfig = field(default_factory=BimConfig)

    # ---------------------------------------------------------------- utils
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        cfg = cls()
        for section, values in d.items():
            if not hasattr(cfg, section):
                raise KeyError(f"Unknown config section: {section!r}")
            sub = getattr(cfg, section)
            if not dataclasses.is_dataclass(sub):
                raise KeyError(f"Not a config section: {section!r}")
            names = {f.name for f in dataclasses.fields(sub)}
            for k, v in values.items():
                if k not in names:
                    raise KeyError(f"Unknown config key: {section}.{k}")
                cur = getattr(sub, k)
                if k in ("kmer_list", "depth_list"):
                    v = _parse_int_list(v)
                elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                    v = tuple(v)
                setattr(sub, k, v)
        return cfg

    def validate(self) -> List[str]:
        """All cross-field validation the reference performs in regulators
        (arguments.py:265-293 etc.), returned as a list of problems."""
        problems = []
        a = self.assemble
        if any(k % 2 == 0 for k in a.kmer_list):
            problems.append("all k-mer lengths must be odd")
        if sorted(a.kmer_list) != a.kmer_list:
            a.kmer_list = sorted(a.kmer_list)
        if len(a.depth_list) > len(a.kmer_list):
            # shrinking the k list keeps the paired prefix of depth gates
            a.depth_list = a.depth_list[: len(a.kmer_list)]
        elif 0 < len(a.depth_list) < len(a.kmer_list):
            problems.append("depth_list must be empty or match kmer_list length")
        if a.prune_depth < 0:
            problems.append("prune depth lower than 0")
        if not 0 <= a.prune_level <= 3:
            problems.append("prune level must be in 0..3")
        if self.search.min_abundance <= 0:
            problems.append("minimum abundance must be positive")
        if not 0 <= self.search.taxa_tolerance <= 6:
            problems.append("taxa tolerance must be in 0..6")
        if self.search.merge_method not in (0, 1, 2):
            problems.append("merge method must be 0, 1 or 2")
        an = self.annotate
        if an.max_contig_length < 0:
            problems.append("max contig length must be >= 0")
        if an.hmmer_score < 0 or an.hmmer_e < 0:
            problems.append("hmmer score/e-value limits must be >= 0")
        gc = an.genetic_code
        if gc is not None and gc not in VALID_GENETIC_CODES:
            problems.append(f"genetic code table {gc} not supported")
        if self.bim.max_iteration <= 0:
            self.bim.max_iteration = 32767
        return problems


# NCBI translation tables we ship (mitochondrial + standard);
# reference: arguments.py saa_regulator gene_code map.
VALID_GENETIC_CODES = (1, 2, 3, 4, 5, 9, 13, 14, 16, 21, 22, 23, 24, 25)


def generate_config(cfg: PipelineConfig, path: str) -> None:
    """``--generate-config`` parity (reference utility/parser.py:373-378):
    write the resolved config as a python file the user can edit and pass
    back via ``--config``."""
    import pprint

    with open(path, "w") as f:
        f.write("# Generated mitoflex_tpu_torch configuration.\n")
        f.write("# Edit values and pass back with --config. Unknown keys are errors.\n")
        f.write("config = ")
        f.write(pprint.pformat(cfg.to_dict(), indent=2, sort_dicts=False))
        f.write("\n")


def load_config_file(path: str, base: Optional[PipelineConfig] = None) -> PipelineConfig:
    """``--config`` parity (reference utility/parser.py:380-389): execute the
    python file; it must define ``config`` (a dict of sections) and/or
    top-level section dicts. Values override ``base``."""
    ns = runpy.run_path(path)
    cfg = base or PipelineConfig()
    merged = cfg.to_dict()
    payload = ns.get("config", {})
    for section in list(merged):
        if section in ns and isinstance(ns[section], dict):
            payload.setdefault(section, {}).update(ns[section])
    for section, values in payload.items():
        if section not in merged:
            raise KeyError(f"Unknown config section: {section!r}")
        merged[section].update(values)
    return PipelineConfig.from_dict(merged)
