"""Milliseconds spent in the port's device-to-host reads a million input
bases: the counter ``d2h.wait_ns`` (the time in ``.cpu()`` of
``convert.host`` and ``convert.u32_numpy``: the device's queue draining,
then the copy), over every span of the traced sample."""

from .. import porttrace


def read(r):
    data = porttrace.export(r)
    if data is None:
        return None
    return porttrace.per_mbp(r, porttrace.counter(data, "d2h.wait_ns") / 1e6)
