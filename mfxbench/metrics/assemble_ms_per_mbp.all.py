"""Host-clock milliseconds of the assemble stage (pipeline.run_assemble) a million input
bases, from the harness's span around the call (ending in a device sync),
in the traced sample."""


def read(r):
    return r.span_ms("assemble") / (r.bases / 1e6) if r.bases and any(
        s["name"] == "assemble" for s in r.spans) else None
