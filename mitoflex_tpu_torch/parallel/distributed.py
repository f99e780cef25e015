"""Process sharding for the port.

``shard_info`` reports this process's (rank, world size) from
``torch.distributed`` when a process group is up, else (0, 1). The FASTQ
byte-range splitters are jax-free and come from the JAX package's module.
Multi-device and multi-process runs of the stages are not ported yet
(ROADMAP).
"""

from __future__ import annotations

from typing import Tuple

import torch.distributed as torch_dist

from mitoflex_tpu.parallel.distributed import (  # noqa: F401  (re-exported)
    host_file_range,
    host_pair_ranges,
)


def shard_info() -> Tuple[int, int]:
    """(process rank, process count); (0, 1) for a single process."""
    if torch_dist.is_available() and torch_dist.is_initialized():
        return torch_dist.get_rank(), torch_dist.get_world_size()
    return 0, 1
