"""Layouts of the DP pipeline kernels of csrc/row_pipeline.cuh: the
Smith-Waterman kernel (csrc/sw.cu, ``ops.sw``) and the genewise kernel
(csrc/genewise.cu, ``ops.genewise``) share it, and this module holds what
their wrappers share: the layout, its limits, the chooser and the argument
checks. Each wrapper keeps its own slot words, step costs and packing
limit.

A pair's query columns run as a pipeline of stages, a stage a warp whose
lanes own ``cols`` columns each (a strip of LANES * cols) and take ``rows``
target positions a step; a pair's stages are the ``warps`` of a block times
the ``cluster`` blocks of a thread-block cluster, and a block is one pair. A
query with more strips than the pair has stages wraps round through a
[B, ceil(Lt / rows), slot] scratch row of 64-bit words.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import KernelLimitError

LANES = 32
KERNEL_COLS = (1, 2, 4)          # the instantiations of cols
# (cols, rows) instantiated: rows target positions a lane a step (a block);
# two positions a step only at 1 or 2 columns a lane (registers)
KERNEL_SHAPES = ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))
KERNEL_MAX_THREADS = 128         # warps x 32 a block (kMaxThreads)
KERNEL_MAX_WARPS = 4             # stages of a pair in a block: one a scheduler
KERNEL_MAX_CLUSTER = 8           # the portable cluster size
KERNEL_MAX_SMEM = 232448         # 227 KB of shared memory a block
KERNEL_DEPTH = 8                 # slots of a hand-off ring (kDepth)
KERNEL_CTL_BYTES = 64            # a warp's ack word and best cell (kCtlBytes)
KERNEL_MAX_TAG = 0xFFFFFFFF      # tags count a link's slots in 32 bits


class PipelineConfig(NamedTuple):
    """A launch layout of the pipeline."""

    cols: int      # C: columns a lane
    warps: int     # P: stages of a pair in a block
    cluster: int   # CL: blocks a pair spans
    wide: bool     # unpacked path fields
    rows: int = 1  # target positions a lane a step

    @property
    def stage_width(self) -> int:
        return LANES * self.cols

    @property
    def stages(self) -> int:
        return self.warps * self.cluster

    @property
    def threads(self) -> int:
        return LANES * self.warps

    def rounds(self, Lq: int) -> int:
        """Rounds of a query of ``Lq`` columns: its strips over the stages."""
        return -(-max(-(-Lq // self.stage_width), 1) // self.stages)

    def blocks(self, Lt: int) -> int:
        """Steps a lane takes over a target of ``Lt`` positions (``rows`` a
        step)."""
        return -(-Lt // self.rows)

    def steps(self, Lq: int, Lt: int) -> int:
        """Stage steps on a pair's chain: its strips' pipeline fill (32 steps
        a strip) and the target's blocks, or its rounds' passes of the
        target where the strips wrap round and that is longer."""
        strips = max(-(-Lq // self.stage_width), 1)
        nb = self.blocks(Lt)
        return max(self.rounds(Lq) * (nb + LANES - 1), LANES * (strips - 1) + nb + LANES - 1)


def slot_words(cfg: PipelineConfig, row_words: dict) -> int:
    """64-bit words of a hand-off slot: ``row_words`` (by ``wide``) for each
    of a step's positions."""
    return cfg.rows * row_words[cfg.wide]


def smem_bytes(cfg: PipelineConfig, K: int, stop: bool, slot: int) -> int:
    """Shared memory a block takes: the [K, K] table (a stop column after it
    where ``stop``), 16-byte aligned, then per warp a ring of KERNEL_DEPTH
    slots of ``slot`` 64-bit words (rounded up to an even count, so that
    each slot is 16-byte aligned) and the control words
    (``rp::smem_bytes``)."""
    table = (K * (K + int(stop)) * 4 + 15) // 16 * 16
    ring = KERNEL_DEPTH * (slot + slot % 2) * 8
    return table + cfg.warps * (ring + KERNEL_CTL_BYTES)


def check_config(cfg: PipelineConfig, Lq: int, Lt: int, K: int, stop: bool, slot: int,
                 packable: bool, what: str) -> None:
    """Raise ValueError unless the kernel can run ``cfg`` on a [*, Lq] x
    [*, Lt] call with a K-letter table (the checks of ``rp::launch`` and of
    the entry points)."""
    problems = []
    if (cfg.cols, cfg.rows) not in KERNEL_SHAPES:
        problems.append(f"{cfg.cols} columns a lane at {cfg.rows} positions a step")
    if min(cfg.warps, cfg.cluster) < 1 or cfg.cluster > KERNEL_MAX_CLUSTER:
        problems.append(f"warps {cfg.warps}, cluster {cfg.cluster}")
    elif cfg.threads > KERNEL_MAX_THREADS:
        problems.append(f"{cfg.threads} threads a block")
    if not cfg.wide and not packable:
        problems.append(f"packed path fields for Lq {Lq}, Lt {Lt}")
    if min(cfg.warps, cfg.cluster, cfg.rows) >= 1 and cfg.cols in KERNEL_COLS \
            and cfg.rounds(Lq) * (cfg.blocks(Lt) + 1) >= KERNEL_MAX_TAG:
        problems.append(f"{cfg.rounds(Lq)} rounds of {Lt} positions")
    if smem_bytes(cfg, K, stop, slot) > KERNEL_MAX_SMEM:
        problems.append(f"{smem_bytes(cfg, K, stop, slot)} bytes of shared memory")
    if problems:
        raise ValueError(f"{what} kernel layout {tuple(cfg)}: " + ", ".join(problems))


def layouts(Lq: int, Lt: int, wide: bool) -> list:
    """The layout of each instantiation (KERNEL_SHAPES order) at these
    widths: a pair's stages up to KERNEL_MAX_WARPS warps a block (one a
    scheduler) times up to KERNEL_MAX_CLUSTER blocks, as many as its strips;
    those whose tags would not fit 32 bits are left out."""
    if Lq < 0 or Lt < 0:
        raise ValueError(f"pipeline layouts: [{Lq}] x [{Lt}]")
    out = []
    for C, rows in KERNEL_SHAPES:
        strips = max(-(-Lq // (LANES * C)), 1)
        P = min(strips, KERNEL_MAX_WARPS)
        cfg = PipelineConfig(C, P, min(KERNEL_MAX_CLUSTER, -(-strips // P)), wide, rows)
        if cfg.rounds(Lq) * (cfg.blocks(Lt) + 1) < KERNEL_MAX_TAG:
            out.append(cfg)
    return out


def choose(Lq: int, Lt: int, wide: bool, step_cost: dict, what: str) -> PipelineConfig:
    """The layout of a [*, Lq] x [*, Lt] call: of ``layouts``, the one whose
    chain (``PipelineConfig.steps``) is shortest in steps of
    ``step_cost[(cols, rows)]``, the first on ties. No caller sends more
    than 64 pairs a call, and up to that the shortest chain was the fastest
    layout at every timed shape on an H100 (PERF.md §6), so the pair
    count plays no part. KernelLimitError where no layout's tags fit 32
    bits."""
    cands = layouts(Lq, Lt, wide)
    if not cands:
        raise KernelLimitError(f"{what} kernel: Lq {Lq} x Lt {Lt} needs more than 2^32 "
                               f"hand-off slots a link; the CPU path takes any")
    return min(cands, key=lambda c: c.steps(Lq, Lt) * step_cost[(c.cols, c.rows)])


def check_inputs(queries: torch.Tensor, q_lens: torch.Tensor, targets: torch.Tensor,
                 t_lens: torch.Tensor, submat, what: str,
                 targets_name: str = "targets") -> tuple:
    """The lengths as int32 and the matrix as a float32 tensor on the
    queries' device; ValueError naming ``what`` unless its kernel takes
    these arguments: int8 queries [B, Lq] and targets [B, Lt], integer
    lengths [B], a square matrix, all contiguous on one device. Lengths of
    another integer type, and a matrix in another type, are converted there;
    a matrix given as an array is converted on the host, so that a call
    launches no kernel but its own."""
    dev = queries.device
    for name, x in (("queries", queries), (targets_name, targets)):
        if x.dim() != 2 or x.dtype != torch.int8 or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"{what}: {name} must be a contiguous int8 tensor [B, L] "
                             f"on {dev}, got {x.dtype} {list(x.shape)} on {x.device}")
    B = queries.shape[0]
    if targets.shape[0] != B:
        raise ValueError(f"{what}: {B} queries but {targets.shape[0]} targets")
    lens = []
    for name, x in (("q_lens", q_lens), ("t_lens", t_lens)):
        if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool \
                or tuple(x.shape) != (B,) or x.device != dev:
            raise ValueError(f"{what}: {name} must be an integer tensor [{B}] on {dev}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}")
        lens.append(x.to(torch.int32).contiguous())
    sub = submat if isinstance(submat, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(submat, dtype=np.float32)).to(dev)
    if sub.device != dev or sub.dim() != 2 or sub.shape[0] != sub.shape[1] \
            or sub.shape[0] < 1:
        raise ValueError(f"{what}: submat must be a square [K, K] matrix on {dev}, got "
                         f"{list(sub.shape)} on {sub.device}")
    return lens[0], lens[1], sub.to(torch.float32).contiguous()


def scratch(cfg: PipelineConfig, B: int, Lq: int, Lt: int, row_words: dict, dev):
    """The [B, ceil(Lt / rows), slot] scratch row where the query's strips
    wrap round, else None."""
    if cfg.rounds(Lq) > 1 and Lt:
        return torch.empty((B, cfg.blocks(Lt), slot_words(cfg, row_words)),
                           dtype=torch.int64, device=dev)
    return None
