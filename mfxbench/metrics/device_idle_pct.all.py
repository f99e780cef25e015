"""Per cent of the traced sample in which no kernel, copy or set ran on the
device: 100 x (1 - busy / window), from the profiler's trace."""


def read(r):
    if not r.trace_window_s or r.busy_s is None:
        return None
    return 100.0 * (1.0 - r.busy_s / r.trace_window_s)
