"""The run's torch device, resolved once at the entry point and passed down.

``uses_host_mirrors(device)`` replaces every ``jax.default_backend() ==
"cpu"`` test of the JAX package: on the CPU the stages take their numpy /
native host formulations (the k-mer counter's per-chunk numpy count and host
merge, the native graph pass, the numpy mapper), which run far faster there
than the tensor formulations; on a CUDA device they take the tensor
formulations, whose kernel calls launch the hand-written CUDA kernels.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The run's device. ``None`` means the card: the current CUDA device,
    or a ``RuntimeError`` when none is visible. The CPU is taken only when
    the caller names it (``device="cpu"``, ``--device cpu``); naming a CUDA
    device on a machine without one raises too. Every public function of
    the port that takes a ``device`` resolves it here, so ``None`` means the
    same thing everywhere."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible (torch.cuda.is_available() is "
                "False) and no device was named; pass device=\"cpu\" "
                "(--device cpu) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def uses_host_mirrors(device: DeviceLike = None) -> bool:
    """True only for the CPU: the host (numpy / native) formulations run."""
    return resolve_device(device).type == "cpu"
