"""Host-clock milliseconds of the annotate stage (pipeline.run_annotate:
tblastn + S1, genewise + G1, the tRNA search's host CYK, the rRNA search's
C1) a sample, from the harness's span, in the traced sample."""


def read(r):
    spans = [s["ms"] for s in r.spans if s["name"] == "annotate"]
    return sum(spans) / len(spans) if spans else None
