"""Command-line interface of the port: ``python -m mitoflex_tpu_torch``.

The parser and the config resolution are the JAX package's own
(``mitoflex_tpu.cli.build_parser`` / ``resolve_config``, jax-free at
import), so flags and config files behave identically. One flag is added,
``--device`` (``cuda``, ``cuda:N`` or ``cpu``; default: CUDA when a card is
visible). ``filter``, ``assemble`` and ``findmitoscaf`` run; the
subcommands not ported yet exit with status 3 and name the ROADMAP item
that ports them.

``MITOFLEX_TORCH_PROFILE=<dir>`` records a ``torch.profiler`` trace of the
command (CPU, plus CUDA on a card) to ``<dir>/trace.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import List, Optional

from mitoflex_tpu.cli import build_parser, resolve_config
from mitoflex_tpu.config import generate_config
from mitoflex_tpu.utils.logger import logger

NOT_PORTED = {
    "annotate": "ROADMAP.md queue 1, item 7 (annotate)",
    "visualize": "ROADMAP.md queue 1, item 8 (visualize)",
    "all": "ROADMAP.md queue 1, item 9 (run_all, run_bim and the CLI)",
    "bim": "ROADMAP.md queue 1, item 9 (run_all, run_bim and the CLI)",
}
PORTED_MODULES = [
    "device", "convert", "kernels", "ops.filter", "ops.psort", "ops.kmer",
    "ops.dbg", "ops.mapper", "ops.phmm", "ops.sw", "models.blast",
    "models.nhmmer", "stages.filter", "stages.assemble", "stages.scaffold",
    "stages.merge", "stages.findmitoscaf", "parallel.distributed", "pipeline",
]


def main(argv: Optional[List[str]] = None) -> int:
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--device", default=None)
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

    if args.command in NOT_PORTED:
        print(f"mitoflex_tpu_torch: '{args.command}' is not ported yet; "
              f"see {NOT_PORTED[args.command]}. The JAX package runs it: "
              f"python -m mitoflex_tpu {args.command} ...")
        return 3

    cfg = resolve_config(args)
    if getattr(args, "generate_config", None):
        generate_config(cfg, args.generate_config)
        print(f"config written to {args.generate_config}")
        return 0

    from .pipeline import PipelineContext, run_assemble, run_filter, run_findmitoscaf

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
        logger.info(f"All done! Time elapsed: {time.time() - t0:.1f}s")
        return 0
    except RuntimeError as e:
        # environment or data problem, not a bug
        logger.error(str(e))
        return 1
    except Exception:
        logger.error("Unexpected error — this looks like a bug:")
        traceback.print_exc()
        logger.replay_suppressed()
        return 2
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            logger.info(f"torch profiler trace written to {profile_dir}")
        logger.finalize()


if __name__ == "__main__":
    raise SystemExit(main())
