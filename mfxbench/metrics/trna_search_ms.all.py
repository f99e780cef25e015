"""Milliseconds of the tRNA search a sample: the port's span
``annotate.trna`` (``models/cmsearch.trna_search``, the host CYK of every
tRNA model), in the traced sample."""

from .. import porttrace


def read(r):
    data = porttrace.export(r)
    if data is None or not porttrace.has_span(data, "annotate.trna") or not r.samples:
        return None
    return porttrace.span_ms(data, "annotate.trna") / r.samples
