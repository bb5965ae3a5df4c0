"""Slot-indexed row-table fetch (port of chord_tpu/ops/row_gather.py).

Every per-pixel material lookup of the g-buffer resolve has one shape: an
(H,W) int32 draw SLOT indexes a small per-draw table of 16 channels (f32
or i32 bit patterns). Kernel K3:

    gather_rows   CUDA kernel csrc/row_gather.cu (CUDA tensors) or
                  gather_rows_plain (CPU tensors)

Replaces chord_tpu/ops/row_gather.py::_kernel (:71). chord_tpu sweeps
table banks with lane shuffles because TPU gathers are slow; on the GPU it
is one thread per pixel doing 16 channel loads from a table that stays in
L1/L2 (2560 rows x 64 B at the bench size) — bound by the 64 B/pixel of
output writes. Values move as int32 bits end to end, so the result is
exact. Negative slots clamp to row 0; slots past the table read zeros (the
reference's zero-padded banks).
"""

from __future__ import annotations

import torch

from . import _cuda
from ._util import bits_i32

CH = 16   # table row width


def pack_table(columns) -> torch.Tensor:
    """Stack up to 16 per-row columns ((N,) f32 or integer tensors; missing
    channels are zero) into the (16, N) int32 channel-major table. f32
    columns keep their bits; integer columns convert to int32."""
    n = columns[0].shape[0]
    dev = columns[0].device

    def to32(col):
        if col.dtype in (torch.float32, torch.int32):
            return bits_i32(col)
        if not col.dtype.is_floating_point:
            return col.to(torch.int32)
        return bits_i32(col.to(torch.float32))

    cols = [to32(col) for col in columns]
    cols += [torch.zeros(n, dtype=torch.int32, device=dev)] * (CH - len(cols))
    return torch.stack(cols, 0).contiguous()


def gather_rows_plain(table_cm: torch.Tensor, slot: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of kernel K3: (16,N) i32 x (H,W) i32 ->
    (16,H,W) i32."""
    n = table_cm.shape[1]
    s = torch.clamp_min(slot, 0).long()
    out = table_cm[:, torch.clamp(s, max=n - 1)]
    return torch.where((s < n)[None], out, torch.zeros((), dtype=torch.int32,
                                                       device=out.device))


def gather_rows(table_cm: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Kernel K3: table_cm (16, N) i32 bit patterns x slot (H, W) i32 ->
    (16, H, W) i32 planes, exact. CPU tensors -> gather_rows_plain."""
    if not slot.is_cuda:
        return gather_rows_plain(table_cm, slot)
    ch, n = table_cm.shape
    h, w = slot.shape
    _cuda.check(table_cm, "table", torch.int32, (CH, n))
    _cuda.check(slot, "slot", torch.int32, (h, w))
    out = torch.empty((CH, h, w), dtype=torch.int32, device=slot.device)
    _cuda.launch("chord_row_gather", _cuda.ptr(table_cm), _cuda.cint(n),
                 _cuda.ptr(slot), _cuda.cint(h * w), _cuda.ptr(out),
                 _cuda.stream())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
