"""Analytic test cases of the port; every `setup` builds on the card
unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device a case is built on: the card by default.  There is no
    CPU fallback: asking for CUDA on a host without a CUDA device
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "case on the CPU")
    return device
