"""Kernel K9: the fusion barrier, an identity copy into a new tensor.

    fusion_barrier   CUDA kernel csrc/fusion_barrier.cu (CUDA tensors) or
                     fusion_barrier_plain (CPU tensors)

Replaces chord_tpu/ops/fusion_barrier.py::_copy_kernel (:29, via
fusion_barrier :33). On this card the kernel is an opaque, materialising
copy: the result has the input's shape, dtype and bytes in a buffer of its
own, written by a kernel that no other operation is fused with (a ctypes
launch is opaque to torch.compile as well). Its one caller is the
fault-bisection tool chord_tpu_torch/tools/repro_eval_kernel.py, variant
`tm_pallas`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda


def fusion_barrier_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K9: a copy of `x` that does not alias it."""
    return x.clone()


def copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch kernel K9 on a contiguous CUDA tensor of any dtype -> a new
    tensor with the same bytes; an empty tensor launches nothing."""
    _cuda.check(x, "x", x.dtype)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _cuda.launch("chord_fusion_barrier", _cuda.ptr(x), _cuda.ptr(out),
                 ctypes.c_longlong(x.numel() * x.element_size()),
                 _cuda.stream())
    fusion_barrier.launches += 1
    return out


def fusion_barrier(x: torch.Tensor) -> torch.Tensor:
    """Kernel K9: identity into a new tensor (same shape, dtype and bytes,
    no aliasing). CPU tensors -> fusion_barrier_plain; a CUDA tensor must
    be contiguous (no hidden copy is made to get there)."""
    if not x.is_cuda:
        return fusion_barrier_plain(x)
    return copy_cuda(x)


fusion_barrier.launches = 0
