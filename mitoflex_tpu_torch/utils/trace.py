"""The port's tracer: named spans and counters inside its stages.

It records while it is enabled (:func:`enable`; ``MITOFLEX_TORCH_PROFILE``
enables it for a command) and while a ``torch.profiler`` records in this
process, so that any profile of the port carries the port's own spans. When
it records nothing, :func:`span` returns one shared null object and
:func:`count` returns, each after a test of two flags; a span that fills a
``walls`` dict (``into=``) still times itself with two ``perf_counter`` calls.

A span records its name and attributes, its start and end on
``time.perf_counter_ns``, its parent (the innermost open span of its thread;
on a thread a prefetch started, the span that opened the prefetch,
:func:`adopt`), its thread, the id of its root span (every span of one
command or sample shares it) and the counters charged to it while it was the
innermost span of its thread. A span without ``k`` takes its parent's. On
the main thread a span also opens a profiler range ``mfx.port.<name>``,
``mfx.port.<name>[k=<k>]`` where it has a ``k``. The profiler drops ranges
opened on threads it did not start, so the spans of other threads are placed
on the trace's clock through anchors: a range ``mfx.port.anchor``, opened by
:func:`enable` and by each root span on the main thread while a profiler
records, whose edges are also taken on ``perf_counter_ns``
(:func:`trace_offset_ns`, :func:`add_to_chrome_trace`).

Spans close where the work already returns to the host: no span or counter
synchronises the device, copies or allocates. :func:`read_back` is the one
device -> host read that charges ``d2h.calls``, ``d2h.bytes`` and
``d2h.wait_ns`` (the time in ``.cpu()``: the device's queue draining, then
the copy).

Records stay in memory until :func:`reset`; :func:`export` returns them.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler
from torch.autograd.profiler import record_function

# ``_is_profiler_enabled`` is torch's own flag, True while a profiler records
_profiler = (_torch_profiler if hasattr(_torch_profiler, "_is_profiler_enabled")
             else types.SimpleNamespace(_is_profiler_enabled=False))
_enabled = False
_records: List[dict] = []
_anchors: List[dict] = []
_ids = itertools.count(1)
_tls = threading.local()
_perf_ns = time.perf_counter_ns

ANCHOR = "mfx.port.anchor"
PREFIX = "mfx.port."


def enable() -> None:
    """Record from now on (and open an anchor if a profiler records)."""
    global _enabled
    _enabled = True
    if _profiler._is_profiler_enabled and threading.current_thread() is threading.main_thread():
        _anchor(None)


def disable() -> None:
    global _enabled
    _enabled = False


def recording() -> bool:
    return _enabled or _profiler._is_profiler_enabled


def reset() -> None:
    """Forget every record and anchor (spans still open stay on their
    threads' stacks)."""
    _records.clear()
    _anchors.clear()


def export() -> dict:
    """The records so far: ``spans`` (dicts, ``t1_ns`` None while open),
    ``anchors`` (``t0_ns``/``t1_ns`` of each ``mfx.port.anchor`` range, in
    the order they were opened) and the main thread's ident."""
    return {"clock": "perf_counter_ns", "main_thread": threading.main_thread().ident,
            "spans": [dict(r, attrs=dict(r["attrs"]), counters=dict(r["counters"]))
                      for r in list(_records)],
            "anchors": [dict(a) for a in list(_anchors)]}


def range_name(name: str, attrs: dict) -> str:
    k = attrs.get("k")
    return f"{PREFIX}{name}" if k is None else f"{PREFIX}{name}[k={k}]"


def _anchor(root: Optional[int]) -> None:
    """An ``mfx.port.anchor`` range, each edge bracketed on
    ``perf_counter_ns``: ``t0_ns``-``t0b_ns`` holds its start, ``t1a_ns``-``t1_ns`` its end."""
    rf = record_function(ANCHOR)
    t0 = _perf_ns()
    rf.__enter__()
    t0b = _perf_ns()
    t1a = _perf_ns()
    rf.__exit__(None, None, None)
    _anchors.append({"root": root, "t0_ns": t0, "t0b_ns": t0b, "t1a_ns": t1a,
                     "t1_ns": _perf_ns()})


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current() -> Optional[dict]:
    """The innermost open span of this thread (its adopted parent where it
    has none), or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else getattr(_tls, "adopted", None)


def adopt(parent: Optional[dict]) -> None:
    """Make ``parent`` (a span of another thread, from :func:`current`) the
    parent of this thread's outermost spans."""
    _tls.adopted = parent


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Wall:
    """A part's seconds added to ``walls[key]``, with the tracer off."""

    __slots__ = ("into", "t0")

    def __init__(self, into) -> None:
        self.into = into

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        walls, key = self.into
        walls[key] = walls.get(key, 0.0) + time.perf_counter() - self.t0
        return False


class _Span:
    __slots__ = ("name", "attrs", "into", "rec", "rf")

    def __init__(self, name: str, attrs: dict, into) -> None:
        self.name = name
        self.attrs = attrs
        self.into = into
        self.rf = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else getattr(_tls, "adopted", None)
        attrs = self.attrs
        if parent is not None and "k" not in attrs and "k" in parent["attrs"]:
            attrs = {"k": parent["attrs"]["k"], **attrs}
        sid = next(_ids)
        thread = threading.current_thread()
        main = thread is threading.main_thread()
        if parent is None and main and _profiler._is_profiler_enabled:
            _anchor(sid)
        rec = {"id": sid, "name": self.name, "attrs": attrs,
               "parent": None if parent is None else parent["id"],
               "root": sid if parent is None else parent["root"],
               "thread": thread.ident, "native_thread": thread.native_id,
               "thread_name": thread.name, "ranged": main,
               "t0_ns": 0, "t1_ns": None, "counters": {}}
        if main:
            self.rf = record_function(range_name(self.name, attrs))
            self.rf.__enter__()
        stack.append(rec)
        _records.append(rec)
        self.rec = rec
        rec["t0_ns"] = _perf_ns()
        return self

    def __exit__(self, *exc):
        t1 = _perf_ns()
        rec = self.rec
        rec["t1_ns"] = t1
        _tls.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.into is not None:
            walls, key = self.into
            walls[key] = walls.get(key, 0.0) + (t1 - rec["t0_ns"]) / 1e9
        return False


def span(name: str, into=None, **attrs):
    """A span named ``name`` (never ``mfx.``-prefixed: the range adds
    ``mfx.port.``); ``into=(walls, key)`` adds its seconds to
    ``walls[key]``, with the tracer on or off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return NULL if into is None else _Wall(into)
    return _Span(name, attrs, into)


def _charge(name: str, value) -> None:
    stack = getattr(_tls, "stack", None)
    if stack:
        counters = stack[-1]["counters"]
        counters[name] = counters.get(name, 0) + value


def count(name: str, value=1) -> None:
    """Add ``value`` (a number, or a numpy array whose sum is added) to the
    counter ``name`` of this thread's innermost span."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    if isinstance(value, np.ndarray):
        value = value.sum().item()
    _charge(name, value)


class _Waited:
    __slots__ = ("counter", "t0")

    def __init__(self, counter: str) -> None:
        self.counter = counter

    def __enter__(self):
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc):
        _charge(self.counter, _perf_ns() - self.t0)
        return False


def waited(counter: str):
    """Charges the nanoseconds inside to the counter ``counter`` of this
    thread's innermost span."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return NULL
    return _Waited(counter)


def read_back(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``; a read from a device charges ``d2h.calls``,
    ``d2h.bytes`` and ``d2h.wait_ns`` to this thread's innermost span."""
    if not (_enabled or _profiler._is_profiler_enabled) or t.device.type == "cpu":
        return t.cpu()
    t0 = _perf_ns()
    out = t.cpu()
    dt = _perf_ns() - t0
    _charge("d2h.calls", 1)
    _charge("d2h.bytes", out.numel() * out.element_size())
    _charge("d2h.wait_ns", dt)
    return out


# --------------------------------------------------------------- readers
def trace_offset_ns(events: List[dict], anchors: List[dict]) -> Optional[float]:
    """Nanoseconds to add to a ``perf_counter_ns`` time to place it on the
    ``ts`` axis of a Chrome trace (``ts`` in us): the median, over the
    trace's ``mfx.port.anchor`` ranges paired in order with ``anchors``
    (those taken while that profiler recorded), of the gap between the two
    clocks' midpoints. None without an anchor."""
    ranges = sorted((float(e["ts"]) * 1e3, float(e.get("dur", 0)) * 1e3)
                    for e in events if e.get("ph") == "X" and e.get("name") == ANCHOR)
    pairs = []
    for (ts, dur), a in zip(ranges, anchors):
        # the edge taken between the closer pair of clock readings
        if a["t0b_ns"] - a["t0_ns"] <= a["t1_ns"] - a["t1a_ns"]:
            pairs.append(ts - (a["t0_ns"] + a["t0b_ns"]) / 2)
        else:
            pairs.append(ts + dur - (a["t1a_ns"] + a["t1_ns"]) / 2)
    if not pairs:
        return None
    pairs.sort()
    return pairs[len(pairs) // 2]


def add_to_chrome_trace(path: str, data: dict) -> int:
    """Adds an :func:`export` to the Chrome trace at ``path`` (from
    ``torch.profiler``'s ``export_chrome_trace``): each span of a thread
    other than the main one becomes a complete event ``mfx.port.<name>``
    on the trace's clock, under its own thread id, with its counters as
    ``args``; a main-thread span's counters go into the ``args`` of its own
    range. Returns the number of events added."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    offset = trace_offset_ns(events, data["anchors"])
    if offset is None:
        return 0
    ranges: Dict[str, List[dict]] = {}
    pid = None
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(PREFIX):
            ranges.setdefault(e["name"], []).append(e)
            pid = e.get("pid", pid)
    added, threads = 0, {}
    for s in data["spans"]:
        if s["t1_ns"] is None:
            continue
        name = range_name(s["name"], s["attrs"])
        ts = (s["t0_ns"] + offset) / 1e3
        if s["ranged"]:
            if s["counters"] and ranges.get(name):
                e = min(ranges[name], key=lambda e: abs(float(e["ts"]) - ts))
                e.setdefault("args", {}).update(s["counters"])
            continue
        tid = s["native_thread"]
        threads[tid] = s["thread_name"]
        events.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "pid": pid if pid is not None else 0, "tid": tid, "ts": ts,
                       "dur": (s["t1_ns"] - s["t0_ns"]) / 1e3,
                       "args": {**{k: v for k, v in s["attrs"].items()}, **s["counters"]}})
        added += 1
    for tid, tname in threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid if pid is not None else 0,
                       "tid": tid, "args": {"name": tname}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return added
