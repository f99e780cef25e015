"""The run's torch device, resolved once at the entry point and passed down.

``uses_host_mirrors(device)`` replaces every ``jax.default_backend() ==
"cpu"`` test of the JAX package: on the CPU the stages take their numpy /
native host formulations (the k-mer counter's per-chunk numpy count and host
merge, the native graph pass, the numpy mapper), which run far faster there
than the tensor formulations; on a CUDA device they take the tensor
formulations, whose kernel calls launch the hand-written CUDA kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The named device, or CUDA when a card is visible, else the CPU.
    Naming a CUDA device on a machine without one raises."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def uses_host_mirrors(device: Optional[torch.device]) -> bool:
    """True only for the CPU: the host (numpy / native) formulations run."""
    return torch.device(device or "cpu").type == "cpu"
