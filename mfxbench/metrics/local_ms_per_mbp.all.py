"""Milliseconds of local extension a million input bases: the port's span
``assemble.local`` (``local_extend``'s rounds through ``ops/mapper.py``),
summed over every k of the traced sample."""

from .. import porttrace


def read(r):
    data = porttrace.export(r)
    if data is None or not porttrace.has_span(data, "assemble.local"):
        return None
    return porttrace.per_mbp(r, porttrace.span_ms(data, "assemble.local"))
