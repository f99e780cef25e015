"""K1, the read filter (``ops/filter.filter_reads``): every byte of the call once."""

from .bytes_once import bound, record  # noqa: F401

OP = ("mitoflex_tpu_torch.ops.filter", "filter_reads")
