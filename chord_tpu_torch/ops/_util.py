"""Small tensor helpers shared by the ops."""

from __future__ import annotations

import functools

import numpy as np
import torch

_I32_MAX_F = 2147483520.0   # largest f32 below 2**31


def f2i(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncating toward zero and SATURATING at the int32
    range, as XLA's convert does (a plain .to(int32) of an out-of-range
    float is undefined on the CPU). NaN maps to 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2147483648.0, _I32_MAX_F).to(torch.int32)


def recip(c) -> float:
    """The f32 reciprocal of a constant divisor: chord_tpu's jitted code
    divides by a constant as XLA compiles it, a multiply by the constant's
    f32 reciprocal (PyTorch's CUDA division by a Python number does the
    same; its CPU division is exact), so the port writes such an `x / c`
    as `x * recip(c)` where rounding decides a later test."""
    return float(np.float32(1.0) / np.float32(c))


def centres(n: int, device) -> torch.Tensor:
    """(arange(n) + 0.5) / n, the n cell centres in [0, 1], rounded as
    chord_tpu's jitted code rounds them (recip)."""
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * \
        recip(n)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded to nearest, as XLA's and CUDA's f32 sqrt
    are. PyTorch's CPU sqrt is a vectorised approximation (an ulp off on
    ~0.6% of f32 inputs with torch 2.13, and in f64 too, so which
    elements round otherwise depends on how the threads split the
    tensor); on the CPU numpy's IEEE root is taken."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().contiguous().numpy()))
    return torch.sqrt(x)


def jitter_rays(base: np.ndarray, frame: int, tilt: float) -> np.ndarray:
    """A frame's ray set (R,3) f32: `base` (R,3) rotated by the frame's
    jitter, base @ (Rz(a) Rx(b))^T with the golden-angle azimuth
    a = f32(frame) * f32(2.3999632297286533) and b = f32(frame) *
    f32(tilt), rounded as chord_tpu's compiled _jitter_rotation and its
    product round it without FMA, and the same on every device: computed
    on the host, the angles' cos and sin in f64 rounded to f32, every
    product of the 3x3 rotations summed (p0 + p1) + p2, one rounding an
    operation (a device's matmul and trig round otherwise)."""
    f32 = np.float32
    a = f32(frame) * f32(2.3999632297286533)
    b = f32(frame) * f32(tilt)
    ca, sa = f32(np.cos(np.float64(a))), f32(np.sin(np.float64(a)))
    cb, sb = f32(np.cos(np.float64(b))), f32(np.sin(np.float64(b)))
    rz = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]], f32)
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cb, -sb], [0.0, sb, cb]], f32)
    rot = (rz[:, 0, None] * rx[0] + rz[:, 1, None] * rx[1]) + \
        rz[:, 2, None] * rx[2]
    base = np.asarray(base, f32)
    return ((base[:, 0, None] * rot[:, 0] + base[:, 1, None] * rot[:, 1])
            + base[:, 2, None] * rot[:, 2])


def host_table(table: np.ndarray, device) -> torch.Tensor:
    """A host table on `device` by a pinned, non-blocking copy: no
    synchronisation."""
    t = torch.from_numpy(table)
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


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
