"""NCBI taxonomy without ete3.

The reference depends on ete3's sqlite NCBI taxonomy (plus a source-level
monkey-patch to bootstrap it, ncbi.py:39-117). Here the taxonomy is a
plain in-memory tree loaded directly from an NCBI taxdump directory
(nodes.dmp / names.dmp) or from a compact TSV snapshot; a small built-in
metazoan tree covering the pipeline's 10 clades ships as fallback so the
taxa filter degrades gracefully instead of requiring a network bootstrap.

API mirrors what the pipeline needs from ete3
(findmitoscaf.py:67-97 get_rank, arguments.py:345-365 name lookup):
name->taxid, lineage ranks, and the rank-match test used by the taxa
filter (filter_taxanomy, findmitoscaf.py:392-436).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# NOTE: the reference spells 'kindom' (sic) in its rank list
# (findmitoscaf.py:64); we use the correct NCBI rank name 'kingdom' but keep
# list order and length identical so tolerance indices line up.
RANK_LIST = ["kingdom", "phylum", "class", "order", "family", "genus", "species"]


@dataclass
class Taxonomy:
    parent: Dict[int, int] = field(default_factory=dict)
    rank: Dict[int, str] = field(default_factory=dict)
    name_of: Dict[int, str] = field(default_factory=dict)
    taxid_of: Dict[str, int] = field(default_factory=dict)

    def add(self, taxid: int, parent: int, rank: str, name: str) -> None:
        self.parent[taxid] = parent
        self.rank[taxid] = rank
        self.name_of[taxid] = name
        self.taxid_of[name] = taxid

    def get_taxid(self, name: str) -> Optional[int]:
        if name in self.taxid_of:
            return self.taxid_of[name]
        # genus fallback (reference get_rank: retry with first word)
        first = name.split(" ")[0]
        return self.taxid_of.get(first)

    def lineage(self, taxid: int) -> List[int]:
        out = []
        seen = set()
        while taxid in self.parent and taxid not in seen:
            out.append(taxid)
            seen.add(taxid)
            nxt = self.parent[taxid]
            if nxt == taxid:
                break
            taxid = nxt
        return out[::-1]

    def get_rank_dict(self, name: str) -> Dict[str, str]:
        """rank -> scientific name along the lineage; 'NA' where absent
        (reference get_rank, findmitoscaf.py:67-97)."""
        out = {r: "NA" for r in RANK_LIST}
        tid = self.get_taxid(name)
        if tid is None:
            return out
        for t in self.lineage(tid):
            r = self.rank.get(t, "")
            if r in out:
                out[r] = self.name_of[t]
        return out

    def rank_of_name(self, name: str) -> Optional[str]:
        tid = self.get_taxid(name)
        return self.rank.get(tid) if tid is not None else None

    def matches_required(self, taxon_name: str, required: str, relaxing: int = 0) -> bool:
        """The taxa-filter test (findmitoscaf.py:410-429): find the deepest
        rank index where the taxon's lineage names the required taxon's
        lineage (non-NA); pass if matched_rank + relaxing >= the rank index
        of the required taxon itself."""
        req_rank = self.rank_of_name(required)
        if req_rank not in RANK_LIST:
            return True  # unknown requirement: do not filter
        required_index = RANK_LIST.index(req_rank)
        taxa_rank = self.get_rank_dict(taxon_name)
        required_rank_d = self.get_rank_dict(required)
        matches = [
            idx
            for idx, r in enumerate(RANK_LIST)
            if required_rank_d[r] == taxa_rank[r] != "NA"
        ]
        matches.append(-1)
        return max(matches) + relaxing >= required_index


def load_taxdump(path: str) -> Taxonomy:
    """Load nodes.dmp/names.dmp from an extracted NCBI taxdump dir."""
    tax = Taxonomy()
    with open(os.path.join(path, "nodes.dmp")) as f:
        for line in f:
            parts = [p.strip() for p in line.split("|")]
            tax.parent[int(parts[0])] = int(parts[1])
            tax.rank[int(parts[0])] = parts[2]
    with open(os.path.join(path, "names.dmp")) as f:
        for line in f:
            parts = [p.strip() for p in line.split("|")]
            if len(parts) > 3 and parts[3] == "scientific name":
                tid = int(parts[0])
                tax.name_of[tid] = parts[1]
                tax.taxid_of[parts[1]] = tid
    return tax


def builtin_metazoa() -> Taxonomy:
    """Minimal built-in tree: the 10 profile clades under Metazoa with a
    representative class/order skeleton, enough for rank matching when no
    taxdump is provided. Taxids follow NCBI where well known."""
    t = Taxonomy()
    t.add(1, 1, "no rank", "root")
    t.add(2759, 1, "superkingdom", "Eukaryota")
    t.add(33208, 2759, "kingdom", "Metazoa")
    clades = {
        "Arthropoda": 6656, "Chordata": 7711, "Mollusca": 6447,
        "Annelida": 6340, "Nematoda": 6231, "Echinodermata": 7586,
        "Platyhelminthes": 6157, "Porifera": 6040, "Bryozoa": 10205,
        "Nemertea": 6217,
    }
    for name, tid in clades.items():
        t.add(tid, 33208, "phylum", name)
    # a small arthropod/chordate skeleton for tests
    t.add(50557, 6656, "class", "Insecta")
    t.add(7147, 50557, "order", "Diptera")
    t.add(7215, 7147, "family", "Drosophilidae")
    t.add(7214, 7215, "genus", "Drosophila")
    t.add(7227, 7214, "species", "Drosophila melanogaster")
    t.add(40674, 7711, "class", "Mammalia")
    t.add(9443, 40674, "order", "Primates")
    t.add(9604, 9443, "family", "Hominidae")
    t.add(9605, 9604, "genus", "Homo")
    t.add(9606, 9605, "species", "Homo sapiens")
    return t


def load_taxonomy(taxdump_dir: Optional[str]) -> Taxonomy:
    if taxdump_dir and os.path.isdir(taxdump_dir):
        return load_taxdump(taxdump_dir)
    return builtin_metazoa()
