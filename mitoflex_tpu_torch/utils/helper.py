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
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from . import trace
from .logger import logger

T = TypeVar("T")


def safe_makedirs(path: str) -> str:
    """mkdir -p that returns the path (reference utility/helper.py:95)."""
    os.makedirs(path, exist_ok=True)
    return path


def timed(name: Optional[str] = None) -> Callable:
    """Decorator logging wall-clock entry/exit per stage
    (reference utility/helper.py:107-124); the call runs inside the stage's
    span (utils/trace.py), named ``name`` or the function's name."""

    def deco(fn: Callable) -> Callable:
        span_name = name or fn.__name__

        @functools.wraps(fn)
        def wrap(*args, **kwargs):
            t0 = time.perf_counter()
            logger.info(f"Entering {fn.__module__}.{fn.__name__}")
            try:
                with trace.span(span_name):
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
