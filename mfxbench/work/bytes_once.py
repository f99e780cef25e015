"""The K1-K4 bound: every input and output byte of a call moved once.

Shared by the read kernels' work files (``filter_reads``,
``merge_sorted_runs``, ``merge_sorted_runs_onepass``, ``sort_words2``), as
``chip_smoke.py`` bounds them: no operation count, the bytes alone.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_MS, nbytes, tensors_in


def record(args, kwargs, out) -> dict:
    """The call's bytes, from shapes alone (no device sync)."""
    return {"bytes": nbytes(*tensors_in(list(args) + list(kwargs.values())),
                            *tensors_in([out]))}


def bound(rec: dict):
    return rec["bytes"] / HBM_BYTES_PER_MS, "bytes"
