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
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class PrefetchIterator(Iterator[T]):
    def __init__(self, source: Iterable[T], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True
        )
        self._thread.start()

    def _produce(self, it: Iterator[T]) -> None:
        try:
            for item in it:
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
        item = self._q.get()
        if item is _DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
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


def prefetch(source: Iterable[T], depth: int = 2) -> PrefetchIterator[T]:
    """Wrap an iterator with a depth-bounded background producer thread."""
    return PrefetchIterator(source, depth)
