"""Seconds from the process's start to the first timed sample: imports,
CUDA init, the kernel and host libraries, the data, the context and the
warm-up sample."""


def read(r):
    return r.setup_s
