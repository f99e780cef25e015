"""The port's own spans and counters (``mitoflex_tpu_torch/utils/trace.py``)
in the traced sample, for the metric readers.

The port's tracer records while a profiler records, so the traced sample's
spans are in its export once the window has closed; a ``port_trace``
attribute of the readings, where the harness hands the export over, is read
first. A port without the tracer, or a run that recorded no span, gives
nothing to read (None).
"""

from __future__ import annotations

from typing import Optional


def export(r) -> Optional[dict]:
    data = getattr(r, "port_trace", None)
    if data is None:
        try:
            from mitoflex_tpu_torch.utils import trace
        except ImportError:
            return None
        data = trace.export()
    return data if data and data.get("spans") else None


def span_ms(data: dict, *names: str) -> float:
    """Milliseconds of every closed span named one of ``names``."""
    return sum(s["t1_ns"] - s["t0_ns"] for s in data["spans"]
               if s["name"] in names and s["t1_ns"] is not None) / 1e6


def counter(data: dict, name: str, main_thread: bool = False) -> float:
    """The counter ``name`` summed over the spans (of the main thread
    alone with ``main_thread``)."""
    return sum(s["counters"].get(name, 0) for s in data["spans"]
               if not main_thread or s["thread"] == data["main_thread"])


def has_span(data: dict, name: str) -> bool:
    return any(s["name"] == name for s in data["spans"])


def per_mbp(r, ms: float) -> Optional[float]:
    return ms / (r.bases / 1e6) if r.bases else None
