"""Small shared helpers.

Counterpart of the reference's utility/helper.py:35-137, minus the shell
command-line assembly: this engine runs no external binaries, so ``shell_call`` /
``concat_command`` have no equivalent. What survives is the timing decorator,
directory creation, and iterator probing.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Iterable, Iterator, TypeVar

from .logger import logger

T = TypeVar("T")


def safe_makedirs(path: str) -> str:
    """mkdir -p that returns the path (reference utility/helper.py:95)."""
    os.makedirs(path, exist_ok=True)
    return path


def timed(enabled: bool = True) -> Callable:
    """Decorator logging wall-clock entry/exit per stage
    (reference utility/helper.py:107-124)."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrap(*args, **kwargs):
            if not enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            logger.info(f"Entering {fn.__module__}.{fn.__name__}")
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                logger.info(f"Leaving {fn.__module__}.{fn.__name__} after {dt:.2f}s")

        return wrap

    return deco


def some(iterable: Iterable[T], n: int = 1) -> bool:
    """True iff the iterable yields MORE than ``n`` items.

    The reference's ``some`` (utility/helper.py:127-137) probes an iterator
    the same way; note SURVEY.md §7 records that the reference call site in
    merge_sequences uses it with inverted logic — we keep the primitive but
    call it correctly.
    """
    it: Iterator[T] = iter(iterable)
    count = 0
    for _ in it:
        count += 1
        if count > n:
            return True
    return False


class StageTimer:
    """Context-manager accumulator for per-stage wall times and counters.

    TPU-side replacement for the reference's ad-hoc byte-ratio logs
    (filter/filter.py:55-58): stages record items/bytes processed so the
    run report can show reads/s and bp/s per stage.
    """

    def __init__(self) -> None:
        self.times: dict[str, float] = {}
        self.counters: dict[str, float] = {}

    def stage(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self_inner):
                self_inner.t0 = time.perf_counter()
                return self_inner

            def __exit__(self_inner, *exc):
                timer.times[name] = timer.times.get(name, 0.0) + (
                    time.perf_counter() - self_inner.t0
                )
                return False

        return _Ctx()

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def report(self) -> str:
        lines = ["stage timings:"]
        for k, v in self.times.items():
            lines.append(f"  {k}: {v:.2f}s")
        for k, v in self.counters.items():
            lines.append(f"  {k} = {v:g}")
        return "\n".join(lines)
