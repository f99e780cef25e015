"""Host-clock milliseconds of the filter stage (pipeline.run_filter) a million input
bases, from the harness's span around the call (ending in a device sync),
in the traced sample."""


def read(r):
    return r.span_ms("filter") / (r.bases / 1e6) if r.bases and any(
        s["name"] == "filter" for s in r.spans) else None
