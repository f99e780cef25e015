"""Host-clock milliseconds of findmitoscaf's nhmmer searches
(models/nhmmer.nhmmer_search: windowing, V1, V2, the hit frame; the
additional check's search included) a million input contig bases, from the
harness's spans, in the traced sample."""


def read(r):
    ms = r.span_ms("nhmmer", parent="findmitoscaf")
    return ms / (r.bases / 1e6) if ms and r.bases else None
