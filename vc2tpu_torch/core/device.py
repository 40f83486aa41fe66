"""Device choice for the port's entry points, and the device a kernel
launch goes to.

Entry points run on the card unless the caller asks for the CPU: a missing
card is an error, never a silent move to the CPU. A kernel is launched on
the card that holds its tensors (``guard``), whichever card is current.
"""

from __future__ import annotations

import contextlib

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card (``cuda``).
    Raises RuntimeError when a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def guard(t: torch.Tensor):
    """The context a kernel launch on ``t`` runs in: ``torch.cuda.device``
    of the card that holds ``t`` (the ``<<<>>>`` launch inside a
    ``*_launch`` entry goes to the current device, and a function
    attribute is set there), and nothing for a tensor off the card."""
    if t.device.type == "cuda":
        return torch.cuda.device(t.device)
    return contextlib.nullcontext()
