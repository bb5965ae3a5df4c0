"""Where the port's entry points put their tensors.

Every entry point that makes tensors takes `device=None`, meaning the
card: the port runs on the GPU unless the caller asks for the CPU (the
CPU tests pass `device="cpu"`). Without a CUDA device the first tensor
made there raises, as CUDA does; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """None -> the current CUDA device; anything else as torch reads it."""
    return torch.device("cuda") if device is None else torch.device(device)
