"""FASTA description key=value codec — the contig metadata contract.

The whole pipeline tags contigs with ``flag=F multi=D len=L`` in the FASTA
description line; this codec reproduces the reference's contract
(utility/bio/seq.py:28-36) so outputs interoperate: every token of the
description containing ``=`` is parsed as key=value, values are int/float
where possible.

Special values used downstream (SURVEY.md §2):
- ``multi=32767`` is the sentinel depth for merged/scaffolded sequences
  (assemble/scaffold_wrapper.py:80-91, misc/fastmathcal merge records).
- ``flag`` bit 1 marks circular sequences.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

Value = Union[int, float, str]

MERGED_MULTI_SENTINEL = 32767


def _coerce(v: str) -> Value:
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def decompile(description: str) -> Dict[str, Value]:
    """Parse ``'id flag=1 multi=123.4 len=567'`` → dict (id under key '' )."""
    out: Dict[str, Value] = {}
    toks = description.split()
    if toks and "=" not in toks[0]:
        out[""] = toks[0]
        toks = toks[1:]
    for tok in toks:
        if "=" in tok:
            k, _, v = tok.partition("=")
            out[k] = _coerce(v)
    return out


def compile_seq(attrs: Dict[str, Value], seq_id: str = "") -> str:
    """Inverse of :func:`decompile`: dict → description string."""
    parts = [seq_id] if seq_id else []
    for k, v in attrs.items():
        if k == "":
            continue
        parts.append(f"{k}={v}")
    return " ".join(parts)


def contig_header(seq_id: str, flag: int, multi: float, length: int) -> str:
    """The canonical contig header used across stages."""
    multi_s = f"{multi:.4f}".rstrip("0").rstrip(".") if isinstance(multi, float) else str(multi)
    return f"{seq_id} flag={flag} multi={multi_s} len={length}"


def parse_contig_header(description: str) -> Tuple[str, int, float, int]:
    """Return (id, flag, multi, len) with safe defaults."""
    d = decompile(description)
    return (
        str(d.get("", "")),
        int(d.get("flag", 0) or 0),
        float(d.get("multi", 0.0) or 0.0),
        int(d.get("len", 0) or 0),
    )
