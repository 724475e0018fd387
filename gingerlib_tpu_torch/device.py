"""The port's device rule, in one place."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the GPU, and an error if there is none; anything else is
    taken as given, a CUDA device without an index getting the one a tensor
    created there gets (``"cuda"`` -> ``cuda:<current device>``), so that
    two names of one device compare equal.  Nothing in the port looks for a
    GPU and carries on without one: the CPU is used only when the caller
    names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gingerlib_tpu_torch runs on a CUDA device unless "
                "device='cpu' is passed explicitly, and "
                "torch.cuda.is_available() is False")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
