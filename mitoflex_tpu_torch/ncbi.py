"""NCBI taxonomy bootstrap tool.

Counterpart of the reference's standalone ``ncbi.py`` (ncbi.py:39-117,
which downloads taxdump.tar.gz into ete3's sqlite with a source-level
monkey-patch). This engine needs no sqlite and no ete3: the taxonomy is
loaded directly from an extracted taxdump (models/taxonomy.py). This tool

- extracts a local ``taxdump.tar.gz`` into a directory usable as
  ``run.taxonomy_dump`` (the reference's offline fallback path,
  ncbi.py:106-113), and
- optionally compacts nodes.dmp/names.dmp into a single small TSV snapshot
  (scientific names only) for faster startup.

Run: ``python -m mitoflex_tpu_torch.ncbi --archive taxdump.tar.gz --out DIR``
(no network access is attempted — supply the archive).
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
from typing import Optional


def extract_taxdump(archive: str, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(archive) as tf:
        members = [m for m in tf.getmembers() if m.name in ("nodes.dmp", "names.dmp")]
        if not members:
            raise RuntimeError("archive does not contain nodes.dmp/names.dmp")
        tf.extractall(out_dir, members=members)
    return out_dir


def compact_taxdump(taxdump_dir: str, out_tsv: str) -> str:
    """nodes.dmp + names.dmp -> one TSV: taxid, parent, rank, name."""
    from .models.taxonomy import load_taxdump

    tax = load_taxdump(taxdump_dir)
    with open(out_tsv, "w") as f:
        for tid, parent in tax.parent.items():
            name = tax.name_of.get(tid, "")
            rank = tax.rank.get(tid, "no rank")
            f.write(f"{tid}\t{parent}\t{rank}\t{name}\n")
    return out_tsv


def load_compact(path: str):
    from .models.taxonomy import Taxonomy

    tax = Taxonomy()
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 4:
                continue
            tid, parent, rank, name = parts
            tax.add(int(tid), int(parent), rank, name)
    return tax


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archive", required=True, help="local taxdump.tar.gz")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--compact", action="store_true",
                    help="also write a compact taxonomy.tsv snapshot")
    args = ap.parse_args(argv)
    extract_taxdump(args.archive, args.out)
    print(f"extracted taxdump into {args.out}")
    if args.compact:
        tsv = compact_taxdump(args.out, os.path.join(args.out, "taxonomy.tsv"))
        print(f"compact snapshot at {tsv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
