"""S1, Smith-Waterman (``ops/sw.sw_align``).

Frozen copy of ``chip_smoke.py``'s ``SW_OPS_PER_CELL`` and ``_sw_bound``:
each row's query length x target length cells at 61 float32 operations a
cell, against the inputs and the nine 4-byte output fields once.
"""

from __future__ import annotations

from .peaks import nbytes, roofline

OP = ("mitoflex_tpu_torch.ops.sw", "sw_align")
SW_OPS_PER_CELL = 61


def record(args, kwargs, out) -> dict:
    import torch

    q, ql, t, tl, sub = args[:5]
    sub_bytes = nbytes(sub) if isinstance(sub, torch.Tensor) else 4 * len(sub) ** 2
    return {"Lq": int(q.shape[1]), "Lt": int(t.shape[1]), "ql": ql, "tl": tl,
            "bytes": nbytes(q, ql, t, tl) + sub_bytes + 9 * 4 * int(q.shape[0])}


def cells(ql, tl, Lq: int, Lt: int) -> int:
    import torch

    return int((torch.as_tensor(ql).to(torch.int64).clamp(0, Lq)
                * torch.as_tensor(tl).to(torch.int64).clamp(0, Lt)).sum())


def bound(rec: dict):
    return roofline(cells(rec["ql"], rec["tl"], rec["Lq"], rec["Lt"]) * SW_OPS_PER_CELL,
                    rec["bytes"])
