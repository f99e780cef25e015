"""Milliseconds of k-mer counting a million input bases: the port's spans
``assemble.count`` (reads into ``KmerCounter``, K4 / K2 / K3, the merged
table's gate, the contig overlay) and ``assemble.mercy``, summed over every
k of the traced sample."""

from .. import porttrace


def read(r):
    data = porttrace.export(r)
    if data is None or not porttrace.has_span(data, "assemble.count"):
        return None
    return porttrace.per_mbp(r, porttrace.span_ms(data, "assemble.count", "assemble.mercy"))
