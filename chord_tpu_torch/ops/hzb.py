"""Hierarchical Z-buffer build + occlusion sampling (port of
chord_tpu/ops/hzb.py; reference hzb.cpp + hzb_mainview_culling.hlsl).

Reverse-Z (1 = near, 0 = far/empty). The pyramid keeps the MIN depth of
each footprint and is stored flattened with static per-level offsets, so
an occlusion test gathers from a runtime-picked mip with integer math.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ._util import f2i


class HZBPyramid(NamedTuple):
    """Flattened min-depth pyramid + static layout metadata."""

    flat: torch.Tensor            # (total,) f32 all levels concatenated
    widths: Tuple[int, ...]
    heights: Tuple[int, ...]
    offsets: Tuple[int, ...]
    mip0_w: int                   # pixel size the pyramid was built from
    mip0_h: int

    @property
    def levels(self) -> int:
        return len(self.widths)


def hzb_layout(width: int, height: int, max_levels: int = 12
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """Static pyramid layout; level 0 is the half-res first reduction."""
    ws, hs, offs = [], [], []
    w, h = (width + 1) // 2, (height + 1) // 2
    off = 0
    for _ in range(max_levels):
        ws.append(w)
        hs.append(h)
        offs.append(off)
        off += w * h
        if w == 1 and h == 1:
            break
        w, h = max(1, (w + 1) // 2), max(1, (h + 1) // 2)
    return tuple(ws), tuple(hs), tuple(offs)


def _reduce2_min(x: torch.Tensor) -> torch.Tensor:
    """2x2 min; odd dims zero-padded (depth 0 = far, absorbing for min)."""
    h, w = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))


def build_hzb(depth: torch.Tensor) -> HZBPyramid:
    """(H,W) reverse-Z depth -> min-depth (far) pyramid."""
    h, w = depth.shape
    ws, hs, offs = hzb_layout(w, h)
    mips = []
    cur = _reduce2_min(depth)
    for lw, lh in zip(ws, hs):
        assert cur.shape == (lh, lw), (cur.shape, lh, lw)
        mips.append(cur.reshape(-1))
        if lw == 1 and lh == 1:
            break
        cur = _reduce2_min(cur)
    return HZBPyramid(flat=torch.cat(mips), widths=ws, heights=hs,
                      offsets=offs, mip0_w=w, mip0_h=h)


def valid_depth_range(depth: torch.Tensor, z_near: torch.Tensor
                      ) -> torch.Tensor:
    """Valid-depth min/max reduce -> (2,) view-space (near, far) distances
    of the frame's occupied depth (reference hzb.hlsl:11-19; feeds next
    frame's cascade fit). Reverse-Z infinite far: ndc = z_near / view_z.
    Empty pixels (ndc 0) are excluded; an all-empty frame gives near >
    far, which callers read as "no valid range"."""
    valid = depth > 0.0
    near_ndc = depth.amax()                             # nearest pixel
    far_ndc = torch.where(valid, depth, torch.full_like(depth, float("inf"))
                          ).amin()
    near_v = z_near / torch.clamp_min(near_ndc, 1e-12)
    far_v = z_near / torch.clamp_min(far_ndc, 1e-12)    # inf ndc -> ~0
    return torch.stack([near_v, far_v]).to(torch.float32)


_CORNERS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
            for sz in (-1, 1)]


def occlusion_test_spheres(hzb: HZBPyramid, center_tw: torch.Tensor,
                           radius: torch.Tensor,
                           tw_to_clip: torch.Tensor) -> torch.Tensor:
    """-> (N,) bool VISIBLE (False = definitely occluded).

    Projects the sphere's AABB corners to a conservative screen rect +
    nearest depth and tests 4 texels of the mip whose texel covers the
    rect. Behind-camera / eye-inside / offscreen -> visible."""
    dev = center_tw.device
    corners = torch.tensor(_CORNERS, dtype=torch.float32, device=dev)
    pts = center_tw[:, None, :] + corners[None, :, :] * radius[:, None, None]
    m = tw_to_clip
    clip = (pts[..., 0:1] * m[0] + pts[..., 1:2] * m[1] +
            pts[..., 2:3] * m[2] + m[3])                      # (N,8,4)
    w_ = clip[..., 3]
    any_near = (w_ <= 1e-5).any(dim=1)
    w_safe = torch.clamp_min(w_, 1e-5)
    ndc = clip[..., :3] / w_safe[..., None]
    u = (ndc[..., 0] * 0.5 + 0.5) * hzb.mip0_w * 0.5
    v = (0.5 - ndc[..., 1] * 0.5) * hzb.mip0_h * 0.5
    z_near_pt = ndc[..., 2].amax(dim=1)

    u0, u1 = u.amin(dim=1), u.amax(dim=1)
    v0, v1 = v.amin(dim=1), v.amax(dim=1)
    ext = torch.maximum(u1 - u0, v1 - v0)
    level = torch.clamp(f2i(torch.ceil(torch.log2(torch.clamp_min(ext, 1.0)))),
                        0, hzb.levels - 1)

    i32 = dict(dtype=torch.int32, device=dev)
    lw = torch.tensor(hzb.widths, **i32)[level]
    lh = torch.tensor(hzb.heights, **i32)[level]
    loff = torch.tensor(hzb.offsets, **i32)[level]
    scale = torch.exp2(level.to(torch.float32))

    def coord(a, lim):
        return torch.minimum(torch.clamp_min(f2i(a / scale), 0), lim - 1)

    x0, x1 = coord(u0, lw), coord(u1, lw)
    y0, y1 = coord(v0, lh), coord(v1, lh)

    def tex(x, y):
        return hzb.flat[(loff + y * lw + x).long()]

    far4 = torch.minimum(torch.minimum(tex(x0, y0), tex(x1, y0)),
                         torch.minimum(tex(x0, y1), tex(x1, y1)))
    occluded = z_near_pt < far4
    return any_near | ~occluded
