"""The port's device rule, shared by every entry point that takes a
``device``: it runs on the card unless the caller asks for the CPU (or
``meta``), and a missing card raises instead of falling back."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present: the port runs on the "
                           "card unless device='cpu' is asked for")
    return device


def current_cuda_device() -> torch.device:
    """The current CUDA device (the default of a process's rank); raises
    without a card."""
    resolve_device("cuda")
    return torch.device("cuda", torch.cuda.current_device())
