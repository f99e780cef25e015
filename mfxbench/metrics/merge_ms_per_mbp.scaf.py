"""Milliseconds of findmitoscaf's merges a million input contig bases: the
port's spans ``findmitoscaf.merge`` (each fixpoint round's blastn, its
seeding, S1 and frame, and the merge algebra), summed over the traced
sample."""

from .. import porttrace


def read(r):
    data = porttrace.export(r)
    if data is None or not porttrace.has_span(data, "findmitoscaf.merge"):
        return None
    return porttrace.per_mbp(r, porttrace.span_ms(data, "findmitoscaf.merge"))
