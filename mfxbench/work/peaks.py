"""Published peaks of one NVIDIA H100 SXM, and the roofline arithmetic.

NVIDIA's data sheet, dense rates, at the full power limit of 700 W: 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3. A card set
below 700 W runs slower under load, so a share states the card's limit
beside it (the run prints it). Frozen copies of ``chip_smoke.py``'s
``F32_OPS_PER_MS``, ``HBM_BYTES_PER_MS`` and ``_bound_ms``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

F32_OPS_PER_MS = 67e9   # H100 SXM float32 outside the tensor cores, 67 TFLOP/s
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s


def tensors_in(values: Iterable) -> list:
    """The tensors among ``values``, one level into tuples and lists."""
    import torch

    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out += [x for x in v if isinstance(x, torch.Tensor)]
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(*tensors) -> float:
    """Least milliseconds the card could take to read the inputs and write
    the outputs given (every byte moved once at the device-memory rate)."""
    return nbytes(*tensors) / HBM_BYTES_PER_MS


def roofline(ops: float, byts: float) -> Tuple[float, str]:
    """(bound ms, what bounds it): the larger of the operations at the
    float32 rate and the bytes at the memory rate."""
    op_ms, mem_ms = ops / F32_OPS_PER_MS, byts / HBM_BYTES_PER_MS
    return (op_ms, "operations") if op_ms >= mem_ms else (mem_ms, "bytes")


def share(op_calls: dict, ops) -> "float | None":
    """Per cent of the roofline reached by the calls of ``ops``: their summed
    bound over their summed device time; None where none ran on the device."""
    calls = [c for op in ops for c in op_calls.get(op, [])]
    device_ms = sum(c[2] for c in calls)
    if not calls or device_ms <= 0:
        return None
    return 100.0 * sum(c[0] for c in calls) / device_ms
