"""Where the port's tensors live.

Every entry point that creates tensors takes ``device=``, defaulting to
``"cuda"``.  Asking for CUDA on a machine without it raises: the port never
falls back to the CPU on its own.  The CPU is for callers that ask for it
(the parity tests do).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a `torch.device`, checked: a CUDA device needs CUDA,
    and only CUDA and CPU devices are served."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} asked for, but torch sees no CUDA "
                "device; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be a cuda or cpu device, got {device!r}")
    return dev
