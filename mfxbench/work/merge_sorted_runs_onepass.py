"""K3, the one-pass merge (``ops/psort.merge_sorted_runs_onepass``): every byte of the call once."""

from .bytes_once import bound, record  # noqa: F401

OP = ("mitoflex_tpu_torch.ops.psort", "merge_sorted_runs_onepass")
