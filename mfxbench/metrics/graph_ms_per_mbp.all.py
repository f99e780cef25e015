"""Milliseconds of the graph pass and its cleaning a million input bases:
the port's span ``assemble.graph`` (``ops/dbg.py``'s pass, each
``stages/graph_clean.analyze_round``, the unitigs), summed over every k of
the traced sample."""

from .. import porttrace


def read(r):
    data = porttrace.export(r)
    if data is None or not porttrace.has_span(data, "assemble.graph"):
        return None
    return porttrace.per_mbp(r, porttrace.span_ms(data, "assemble.graph"))
