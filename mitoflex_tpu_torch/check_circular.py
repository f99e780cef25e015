"""Standalone circularity checker CLI.

Parity with the reference's ``misc/check_circular.py`` main (:58-69):
reports, per sequence in a FASTA, whether its head repeats at its tail
(terminal-overlap DP) and where. Output is JSON
``{seq_id: [f_start, f_end, overlap_len] | null}``.

Run: ``python -m mitoflex_tpu_torch.check_circular --fasta in.fa [--output out.json]``
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from .io.fasta import read_fasta
from .ops.overlap import check_circular


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fasta", required=True, help="input sequences")
    ap.add_argument("--output", default=None, help="write JSON here (default stdout)")
    ap.add_argument("--overlay", type=int, default=8,
                    help="minimum overlap to call circular")
    ap.add_argument("--length", type=int, default=12000,
                    help="minimum sequence length to consider")
    ap.add_argument("--start", type=int, default=300, help="head window, bp")
    ap.add_argument("--end", type=int, default=300, help="tail window, bp")
    args = ap.parse_args(argv)

    results = {
        rec.id: (list(info) if info is not None else None)
        for info, rec in check_circular(
            read_fasta(args.fasta),
            minimum_length=args.length,
            start_length=args.start,
            end_length=args.end,
            overlaps=args.overlay,
        )
    }
    text = json.dumps(results, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
