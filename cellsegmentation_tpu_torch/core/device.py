"""Device resolution shared by every entry point.

Entry points run on the CUDA card unless the caller asks for the CPU. They
never carry on quietly on the CPU when no card is present.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA card (raises when none is present);
    anything else is taken as given, and a CUDA request without a card
    raises too. CUDA devices come back with their index."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def model_device(model: torch.nn.Module, device=None) -> torch.device:
    """``resolve_device(device)``, checked against where ``model`` lives."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have != dev:
        raise ValueError(
            f"the model lives on {have}, the step was asked for {dev}; "
            "build the model on the step's device"
        )
    return dev
