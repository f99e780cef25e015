"""V1 and V2's share of their roofline (ops/phmm.py -> csrc/viterbi.cu):
the summed bound of every call in the traced sample (work/viterbi.py, the
larger of the cells' float32 operations at 67 TFLOP/s and the bytes at
3.35 TB/s) over the summed device time of their kernels."""

from ..work.peaks import share


def read(r):
    return share(r.op_calls, ("viterbi_scores_multi", "viterbi_scan"))
