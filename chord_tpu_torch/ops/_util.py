"""Small tensor helpers shared by the ops."""

from __future__ import annotations

import functools

import torch

_I32_MAX_F = 2147483520.0   # largest f32 below 2**31


def f2i(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncating toward zero and SATURATING at the int32
    range, as XLA's convert does (a plain .to(int32) of an out-of-range
    float is undefined on the CPU). NaN maps to 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2147483648.0, _I32_MAX_F).to(torch.int32)


def bits_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 / i32 -> int32 bit pattern (no conversion)."""
    return x.contiguous().view(torch.int32) if x.dtype != torch.int32 else x


def bits_f32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> f32."""
    return x.contiguous().view(torch.float32)


@functools.lru_cache(maxsize=None)
def const(values, device: torch.device) -> torch.Tensor:
    """An f32 constant (a float or a tuple) on `device`, made once: a
    host-to-device copy inside a frame would synchronise the stream."""
    return torch.tensor(values, dtype=torch.float32, device=device)
