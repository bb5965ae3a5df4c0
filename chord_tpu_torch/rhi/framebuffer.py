"""Visibility packing and frame history (port of
chord_tpu/rhi/framebuffer.py).

Visibility ids are kept as int32 BIT PATTERNS inside the port: chord_tpu's
raster compares payloads as signed int32, and torch.uint32 lacks most ops.
`vis_to_uint32` converts at the API edge only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# (instanceId+1):25 | triangleId:7; 0 = empty sky pixel
# (reference: shader/base.h:410-413)
TRI_BITS = 7
TRI_MASK = (1 << TRI_BITS) - 1


def pack_visibility(instance_id: torch.Tensor,
                    tri_id: torch.Tensor) -> torch.Tensor:
    """(instanceId+1):25 | triangleId:7 -> int32 bits; instance_id==-1 -> 0."""
    packed = ((instance_id + 1).to(torch.int32) << TRI_BITS) | (
        tri_id.to(torch.int32) & TRI_MASK)
    return torch.where(instance_id >= 0, packed, torch.zeros_like(packed))


def unpack_visibility(vis: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 visibility bits -> (instance_id with -1 = empty, tri_id).
    The shift is logical (the ids are unsigned on the wire)."""
    vis = vis.to(torch.int32)
    inst = ((vis >> TRI_BITS) & ((1 << (32 - TRI_BITS)) - 1)) - 1
    tri = vis & TRI_MASK
    return inst, tri


def vis_to_uint32(vis: torch.Tensor):
    """int32 visibility bits -> numpy uint32 (for comparison with
    chord_tpu's uint32 render targets)."""
    return vis.detach().cpu().numpy().view("uint32")


@dataclass
class FrameHistory:
    """State carried frame -> frame by the `off` path. `valid` gates all
    history reads; a camera cut sets valid=0 (reference clearHistory).
    chord_tpu's history also carries GI, shadow and DDGI state; those
    fields join with their slices."""

    valid: torch.Tensor         # () f32 0/1
    frame_count: torch.Tensor   # () i32
    hzb_flat: torch.Tensor      # (total,) f32 flattened min-depth pyramid
    depth: torch.Tensor         # (H,W) f32 previous depth
    exposure: torch.Tensor      # () f32 adapted exposure
    tsr_color: torch.Tensor     # (Hp,Wp,3) f32 accumulated TSR colour
    depth_range: torch.Tensor   # (2,) f32 view-space (near, far)

    @classmethod
    def empty(cls, h: int, w: int, post_h: Optional[int] = None,
              post_w: Optional[int] = None, device="cpu") -> "FrameHistory":
        from ..ops.hzb import hzb_layout

        ph, pw = post_h or h, post_w or w
        ws, hs, offs = hzb_layout(w, h)
        total = offs[-1] + ws[-1] * hs[-1]
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            valid=torch.zeros((), **f32),
            frame_count=torch.zeros((), dtype=torch.int32, device=device),
            hzb_flat=torch.zeros((total,), **f32),
            depth=torch.zeros((h, w), **f32),
            exposure=torch.ones((), **f32),
            tsr_color=torch.zeros((ph, pw, 3), **f32),
            depth_range=torch.zeros((2,), **f32),
        )
