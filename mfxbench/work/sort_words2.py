"""K4, the 2-word key sort (``ops/psort.sort_words2``): every byte of the call once."""

from .bytes_once import bound, record  # noqa: F401

OP = ("mitoflex_tpu_torch.ops.psort", "sort_words2")
