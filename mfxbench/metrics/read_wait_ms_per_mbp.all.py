"""Milliseconds the port's main thread waited on the FASTQ prefetch queues
a million input bases: the counter ``io.wait_ns`` of ``io/prefetch.py``'s
consumer, over the main thread's spans (filter and every k of assemble) in
the traced sample."""

from .. import porttrace


def read(r):
    data = porttrace.export(r)
    if data is None:
        return None
    return porttrace.per_mbp(r, porttrace.counter(data, "io.wait_ns", main_thread=True) / 1e6)
