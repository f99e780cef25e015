"""S1's share of its roofline (ops/sw.py -> csrc/sw.cu): the summed bound of
every ``sw_align`` call in the traced sample, blastn's under the merge and
tblastn's under annotate (work/sw_align.py, the larger of the cells' float32
operations at 67 TFLOP/s and the bytes at 3.35 TB/s), over the summed
device time of their kernels."""

from ..work.peaks import share


def read(r):
    return share(r.op_calls, ("sw_align",))
