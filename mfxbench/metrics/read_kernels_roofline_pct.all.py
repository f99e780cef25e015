"""K1-K4's share of their roofline (ops/filter.py, ops/psort.py): the
summed bound of every call in the traced sample (work/, every byte once at
3.35 TB/s) over the summed device time of their kernels."""

from ..work.peaks import share


def read(r):
    return share(r.op_calls, ("filter_reads", "merge_sorted_runs",
                              "merge_sorted_runs_onepass", "sort_words2"))
