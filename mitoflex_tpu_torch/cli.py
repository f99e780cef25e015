"""Command-line interface of the port: ``python -m mitoflex_tpu_torch``.

The parser and the config resolution (``build_parser``, ``resolve_config``)
are the port's own copies of the JAX package's, so flags and config files
behave identically. One flag is added,
``--device`` (``cuda``, ``cuda:N`` or ``cpu``). Without it the command runs
on the card and fails, naming the missing card, when no CUDA device is
visible: the CPU is taken only when ``--device cpu`` asks for it. Every
subcommand of the JAX package's CLI runs (``filter``, ``assemble``,
``findmitoscaf``, ``annotate``, ``visualize``, ``all``, ``bim``,
``load_modules``) and prints the same one-line JSON.

``MITOFLEX_TORCH_PROFILE=<dir>`` records a ``torch.profiler`` trace of the
command (CPU, plus CUDA on a card) to ``<dir>/trace.json``, with the port's
tracer (utils/trace.py) on: the main thread's spans are ranges
``mfx.port.<name>`` of the trace (``[k=<k>]`` in assemble), and the spans of
the helper threads (the FASTQ prefetch producers, the k-mer merge gate's
producer), which the profiler cannot see, are added to the file as complete
events on the trace's clock, placed through the ``mfx.port.anchor`` range,
under their own thread ids. Each span's counters (``d2h.*``, ``io.*``,
``count.bases``, ``kmers.solid``, ``graph.rounds``, ...) are its ``args``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import List, Optional

from . import __version__
from .config import PipelineConfig, generate_config, load_config_file
from .utils import trace
from .utils.logger import logger

_SECTION_FLAGS = {
    # flag name -> (section, field)   (reference flag names, arguments.py)
    "deduplication": ("filter", "deduplication"),
    "ns-valve": ("filter", "ns_valve"),
    "keep-region": ("filter", "keep_region"),
    "quality-valve": ("filter", "quality_valve"),
    "percentage-valve": ("filter", "percentage_valve"),
    "trimming": ("filter", "trimming"),
    "truncate-only": ("filter", "truncate_only"),
    # the reference's --disable-filter runs the filter in truncate-only
    # mode (MitoFlex.py:97,104: trunc=args.disable_filter)
    "disable-filter": ("filter", "truncate_only"),
    "insert-size-auto": ("bim", "insert_size_auto"),
    "kmer-list": ("assemble", "kmer_list"),
    "depth-list": ("assemble", "depth_list"),
    "prune-level": ("assemble", "prune_level"),
    "prune-depth": ("assemble", "prune_depth"),
    "insert-size": ("assemble", "insert_size"),
    "disable-local": ("assemble", "disable_local"),
    "disable-scaffolding": ("assemble", "disable_scaffolding"),
    "disable-taxa": ("search", "disable_taxa"),
    "min-abundance": ("search", "min_abundance"),
    "required-taxa": ("search", "required_taxa"),
    "taxa-tolerance": ("search", "taxa_tolerance"),
    "merge-method": ("search", "merge_method"),
    "merge-overlap": ("search", "merge_overlap"),
    "merge-start": ("search", "merge_start"),
    "genetic-code": ("annotate", "genetic_code"),
    "clade": ("annotate", "clade"),
    "max-contig-length": ("annotate", "max_contig_length"),
    "wider-taxa": ("annotate", "wider_taxa"),
    "use-hmmer": ("annotate", "use_hmmer"),
    "hmmer-score": ("annotate", "hmmer_score"),
    "hmmer-e": ("annotate", "hmmer_e"),
    "disable-annotation": ("annotate", "disable_annotation"),
    "species-name": ("annotate", "species_name"),
    "disable-visualization": ("visualize", "disable_visualization"),
    "max-iteration": ("bim", "max_iteration"),
    "iteration-ignore": ("bim", "iteration_ignore"),
    "scaffolding-spare": ("bim", "scaffolding_spare"),
    "workname": ("run", "workname"),
    "basedir": ("run", "basedir"),
    "keep-temp": ("run", "keep_temp"),
    "level": ("run", "log_level"),
    "profile-dir": ("run", "profile_dir"),
    "taxonomy-dump": ("run", "taxonomy_dump"),
}

_BOOL_FLAGS = {
    "deduplication", "truncate-only", "disable-local", "disable-scaffolding",
    "disable-taxa", "wider-taxa", "use-hmmer", "disable-annotation",
    "disable-visualization", "keep-temp", "disable-filter",
    "insert-size-auto",
}


def _add_common(p: argparse.ArgumentParser) -> None:
    for flag, (section, field) in _SECTION_FLAGS.items():
        if flag in _BOOL_FLAGS:
            p.add_argument(f"--{flag}", action="store_true", default=None)
        elif flag == "ns-valve":
            # the reference spells it --Ns-valve (arguments.py fastq group)
            p.add_argument("--ns-valve", "--Ns-valve", dest="ns_valve",
                           default=None)
        else:
            p.add_argument(f"--{flag}", default=None)
    p.add_argument("--config", default=None, help="python config file merged over flags")
    p.add_argument("--generate-config", default=None, metavar="PATH",
                   help="write the resolved config to PATH and exit")
    p.add_argument("--threads", default=None, help="accepted for reference CLI "
                   "compatibility; parallelism is device-driven")


_DEVICE_HELP = (
    "--device cuda|cuda:N|cpu may stand anywhere on the command line. "
    "Default: the card, and an error that names the missing card when no "
    "CUDA device is visible; the CPU is taken only when --device cpu asks "
    "for it."
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mitoflex-tpu-torch",
        description=(
            "Mitogenome analysis on NVIDIA GPUs: filter, assemble, find, annotate "
            f"and visualize mitochondrial genomes from NGS data. v{__version__}"
        ),
        epilog=_DEVICE_HELP,
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command", required=True)

    def cmd(name, help_, *, fq=False, fa=False):
        p = sub.add_parser(name, help=help_)
        if fq:
            p.add_argument("--fastq1", required=(name in ("filter", "assemble")))
            p.add_argument("--fastq2", default=None)
        if fa:
            p.add_argument("--fastafile", default=None)
        _add_common(p)
        return p

    p = cmd("filter", "filter out unqualified reads from raw FASTQ", fq=True)
    p.add_argument("--cleanq1", default=None,
                   help="cleandata output file 1 (name or absolute path)")
    p.add_argument("--cleanq2", default=None,
                   help="cleandata output file 2 (name or absolute path)")
    cmd("assemble", "assemble clean reads into contigs", fq=True)
    p = cmd("findmitoscaf", "pick mitochondrial scaffolds from contigs", fq=True, fa=True)
    p.add_argument("--from-megahit", action="store_true", default=False,
                   help="contigs carry multi= depth tags already")
    p = cmd("annotate", "annotate genes on picked scaffolds", fa=True)
    p = cmd("visualize", "render the circular genome map", fa=True, fq=True)
    p.add_argument("--locs", "--pos-json", dest="locs", default=None,
                   help="locs.json from annotate (reference --pos-json)")
    p.add_argument("--circular", action="store_true", default=False,
                   help="draw the genome as a closed circle (no break)")
    p = cmd("all", "the whole pipeline: filter->assemble->find->annotate->visualize", fq=True)
    p.add_argument("--resume", action="store_true", default=False,
                   help="skip stages whose outputs already exist in the work dir")
    cmd("bim", "iterative bait-map-assemble loop (experimental, like the reference)", fq=True)
    sub.add_parser("load_modules", help="import every stage module as an installation check")
    return parser


def resolve_config(args: argparse.Namespace) -> PipelineConfig:
    cfg = PipelineConfig()
    for flag, (section, field) in _SECTION_FLAGS.items():
        val = getattr(args, flag.replace("-", "_"), None)
        if val is None:
            continue
        cur = getattr(getattr(cfg, section), field)
        if flag in _BOOL_FLAGS:
            val = bool(val)
        elif field in ("kmer_list", "depth_list"):
            val = [int(x) for x in str(val).split(",")]
        elif field == "keep_region":
            # reference format "beg,end" ("0,0" = full length)
            try:
                beg, end = (int(x) for x in str(val).split(","))
            except ValueError:
                print(f"config error: --keep-region expects 'beg,end', got {val!r}",
                      file=sys.stderr)
                raise SystemExit(2)
            val = (beg, end)
        elif field == "log_level":
            # reference --level takes names (arguments.py:109-113)
            names = ["code", "debug", "info", "warn", "error"]
            if str(val) in names:
                val = names.index(val)
            else:
                try:
                    val = int(val)
                except ValueError:
                    print(f"config error: --level must be one of {names} "
                          f"or 0-4, got {val!r}", file=sys.stderr)
                    raise SystemExit(2)
        elif isinstance(cur, bool):
            val = str(val).lower() in ("1", "true", "yes", "y")
        elif isinstance(cur, int) or (cur is None and field in ("genetic_code",)):
            # coerce by declared runtime type; a fractional value for an
            # int-typed knob (e.g. --trimming 0.5 Gbp) falls through to float
            try:
                val = int(val)
            except ValueError:
                try:
                    val = float(val)
                except ValueError:
                    print(f"config error: --{flag} expects a number, got {val!r}",
                          file=sys.stderr)
                    raise SystemExit(2)
        elif isinstance(cur, float):
            try:
                val = float(val)
            except ValueError:
                print(f"config error: --{flag} expects a number, got {val!r}",
                      file=sys.stderr)
                raise SystemExit(2)
        setattr(getattr(cfg, section), field, val)
    if getattr(args, "config", None):
        cfg = load_config_file(args.config, cfg)
    problems = cfg.validate()
    if problems:
        for p in problems:
            print(f"config error: {p}", file=sys.stderr)
        raise SystemExit(2)
    return cfg


PORTED_MODULES = [
    "device", "convert", "config", "kernels", "io.encoding", "io.fasta",
    "io.fastq", "io.prefetch", "utils.helper", "utils.logger", "utils.seq",
    "utils.workdir", "native.fastq_native", "native.dedup_native",
    "native.merge_native", "native.graph_native", "ops.filter", "ops.psort",
    "ops.kmer", "ops.dbg", "ops.mapper", "ops.overlap", "ops.phmm", "ops.spill",
    "ops.sw", "ops.cyk", "ops.cyk_device", "ops.genewise", "bio.wuss", "bio.circos",
    "models.blast", "models.cmsearch", "models.cm", "models.codon", "models.hmm",
    "models.nhmmer", "models.profiles", "models.proteindb", "models.taxonomy",
    "stages.filter", "stages.assemble", "stages.graph_clean", "stages.scaffold",
    "stages.merge", "stages.findmitoscaf", "stages.annotate", "stages.visualize",
    "parallel.distributed", "parallel.mesh", "parallel.graph_mesh",
    "testing.synth", "testing.profile_fixture", "testing.cm_fixture", "testing.kernel_cases",
    "pipeline", "check_circular", "ncbi",
]


def _log_process_state() -> None:
    """Process and system memory, open files and threads, for the log of a
    bug-class failure; needs ``psutil`` and says so where it is missing."""
    try:
        import psutil
    except ImportError:
        logger.error("process state: not available (psutil is not installed)")
        return

    def read(fn):
        # a reading that fails is named in its place (in a container psutil can
        # trip over what /proc holds); the failure being handled keeps its
        # exit status and its replay
        try:
            return fn()
        except Exception as e:
            return f"unreadable ({type(e).__name__})"

    proc = psutil.Process()
    logger.error(
        f"process state: rss={read(lambda: f'{proc.memory_info().rss >> 20}MiB')} "
        f"vms={read(lambda: f'{proc.memory_info().vms >> 20}MiB')} "
        f"open_files={read(lambda: len(proc.open_files()))} "
        f"threads={read(proc.num_threads)}"
    )

    def system_memory():
        vm = psutil.virtual_memory()
        return (f"{vm.percent}% used "
                f"({(vm.total - vm.available) >> 20}/{vm.total >> 20} MiB)")

    logger.error(f"system memory: {read(system_memory)}")


def main(argv: Optional[List[str]] = None) -> int:
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--device", default=None, help=_DEVICE_HELP)
    known, rest = pre.parse_known_args(argv)
    args = build_parser().parse_args(rest)

    if args.command == "load_modules":
        import importlib

        failed = []
        for m in PORTED_MODULES:
            try:
                importlib.import_module(f"mitoflex_tpu_torch.{m}")
                print(f"  ok: {m}")
            except Exception as e:  # report every module, then fail
                failed.append(m)
                print(f"FAIL: {m}: {e}")
        print("All modules loaded." if not failed else f"{len(failed)} module(s) failed.")
        return 1 if failed else 0

    cfg = resolve_config(args)
    if getattr(args, "generate_config", None):
        generate_config(cfg, args.generate_config)
        print(f"config written to {args.generate_config}")
        return 0

    from .pipeline import (PipelineContext, run_all, run_annotate, run_assemble,
                           run_bim, run_filter, run_findmitoscaf, run_visualize)

    t0 = time.time()
    ctx = PipelineContext.create(cfg, known.device)
    profile_dir = os.environ.get("MITOFLEX_TORCH_PROFILE")
    prof = None
    if profile_dir:
        import torch.profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            acts.append(tp.ProfilerActivity.CUDA)
        prof = tp.profile(activities=acts)
        prof.__enter__()
        trace.reset()
        trace.enable()
        logger.info(f"torch profiler tracing to {profile_dir}")
    try:
        if args.command == "filter":
            res = run_filter(ctx, args.fastq1, args.fastq2,
                             cleanq1=args.cleanq1, cleanq2=args.cleanq2)
            print(json.dumps({"clean1": res.clean1, "clean2": res.clean2,
                              "reads_kept": res.reads_kept}))
        elif args.command == "assemble":
            out = run_assemble(ctx, args.fastq1, args.fastq2)
            print(json.dumps({"contigs": out}))
        elif args.command == "findmitoscaf":
            res = run_findmitoscaf(ctx, args.fastafile, args.fastq1, args.fastq2,
                                   from_megahit=args.from_megahit)
            print(json.dumps({"picked": res.path}))
        elif args.command == "annotate":
            res = run_annotate(ctx, args.fastafile)
            print(json.dumps({"locs": res.path, "genes": len(res.locs),
                              "circular": res.circular}))
        elif args.command == "visualize":
            locs = {}
            if args.locs:
                with open(args.locs) as f:
                    locs = json.load(f)
            outs = run_visualize(ctx, args.fastafile, locs, args.fastq1,
                                 args.fastq2, circular=args.circular)
            print(json.dumps({"outputs": outs}))
        elif args.command == "all":
            summary = run_all(ctx, args.fastq1, args.fastq2, resume=args.resume)
            print(json.dumps(summary, default=str))
        elif args.command == "bim":
            out = run_bim(ctx, args.fastq1, args.fastq2)
            print(json.dumps({"picked": out}))
        if not cfg.run.keep_temp and args.command == "all":
            ctx.workdir.clean_temp()
        logger.info(f"All done! Time elapsed: {time.time() - t0:.1f}s")
        return 0
    except RuntimeError as e:
        # environment or data problem, not a bug
        logger.error(str(e))
        return 1
    except Exception:
        # bug-class failure: dump process state like the reference's
        # excepthook (MitoFlex.py:423-462 — open files, memory)
        logger.error("Unexpected error — this looks like a bug:")
        traceback.print_exc()
        _log_process_state()
        logger.replay_suppressed()
        return 2
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            trace.disable()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            trace.add_to_chrome_trace(path, trace.export())
            trace.reset()
            logger.info(f"torch profiler trace written to {profile_dir}")
        logger.finalize()


if __name__ == "__main__":
    raise SystemExit(main())
