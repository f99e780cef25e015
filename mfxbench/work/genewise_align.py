"""G1, genewise's frameshift DP (``ops/genewise.genewise_align``).

Frozen copy of ``chip_smoke.py``'s ``GENEWISE_OPS_PER_CELL`` and
``_genewise_bound``: each hit's query length x target length cells at 81
float32 operations a cell, against the inputs, the substitution matrix and
the six 4-byte output fields once.
"""

from __future__ import annotations

import numpy as np

from .peaks import nbytes, roofline
from .sw_align import cells

OP = ("mitoflex_tpu_torch.ops.genewise", "genewise_align")
GENEWISE_OPS_PER_CELL = 81


def record(args, kwargs, out) -> dict:
    import torch

    q, ql, aa, tl, sub = args[:5]
    k2 = sub.numel() if isinstance(sub, torch.Tensor) else np.asarray(sub).size
    return {"Lq": int(q.shape[1]), "T": int(aa.shape[1]), "ql": ql, "tl": tl,
            "bytes": nbytes(q, ql, aa, tl) + 4 * k2 + 6 * 4 * int(q.shape[0])}


def bound(rec: dict):
    return roofline(cells(rec["ql"], rec["tl"], rec["Lq"], rec["T"]) * GENEWISE_OPS_PER_CELL,
                    rec["bytes"])
