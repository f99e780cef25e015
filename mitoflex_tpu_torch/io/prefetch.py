"""Background prefetch for host ingestion.

The reference pipeline overlaps I/O with compute through Unix pipes and
gzip FIFOs between processes (assemble_wrapper.py:171-196,
bim/bim.py:51-56). The TPU engine's analog: a daemon thread pulls batches
from a (native C++ or Python) reader generator into a bounded queue while
the main thread keeps the device busy — disk decode and device compute
overlap instead of alternating.

``prefetch(it, depth)`` wraps any iterator. Exceptions raised by the
producer are re-raised at the consumer's next pull; the producer thread
dies with the process (daemon) if the consumer abandons iteration, and a
``close()``/context-manager interface tears it down deterministically.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, TypeVar

from ..utils import trace

T = TypeVar("T")

_DONE = object()


class PrefetchIterator(Iterator[T]):
    def __init__(self, source: Iterable[T], depth: int = 2, item: str = "io.parse",
                 counters: str = "io", wait: Optional[str] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._item = item
        self._wait = wait
        self._wait_ns = f"{counters}.wait_ns"
        self._batches = f"{counters}.batches"
        self._put_blocked_ns = f"{counters}.put_blocked_ns"
        self._opener = trace.current()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True
        )
        self._thread.start()

    def _produce(self, it: Iterator[T]) -> None:
        trace.adopt(self._opener)
        try:
            with trace.span("prefetch"):
                while True:
                    with trace.span(self._item):
                        item = next(it, _DONE)
                    if item is _DONE:
                        break
                    with trace.waited(self._put_blocked_ns):
                        while not self._stop.is_set():
                            try:
                                self._q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                    if self._stop.is_set():
                        return
            self._q.put(_DONE)
        except BaseException as e:  # propagate to the consumer
            self._q.put(e)

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        if self._stop.is_set():
            raise StopIteration
        with trace.span(self._wait) if self._wait else trace.NULL:
            with trace.waited(self._wait_ns):
                item = self._q.get()
        if item is _DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        trace.count(self._batches)
        return item

    def close(self) -> None:
        """Stop the producer and drain: safe to call mid-iteration (the
        filter stage breaks out early when the Gbp budget is hit)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch(source: Iterable[T], depth: int = 2, item: str = "io.parse",
             counters: str = "io", wait: Optional[str] = None) -> PrefetchIterator[T]:
    """Wrap an iterator with a depth-bounded background producer thread.

    Traced (utils/trace.py): the producer thread runs in a span
    ``prefetch`` whose parent is the span that called this, one span
    ``item`` a pull from ``source``, and charges ``<counters>.put_blocked_ns``
    (the queue was full: the consumer set the pace); the consumer charges
    ``<counters>.wait_ns`` (blocked on the queue) and ``<counters>.batches``
    to its innermost span, inside a span ``wait`` where one is named."""
    return PrefetchIterator(source, depth, item, counters, wait)
