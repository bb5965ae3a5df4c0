"""Tile-local history reprojection (port of
chord_tpu/ops/tile_reproject.py).

Each 32x128 output tile reprojects the history by ITS OWN mean motion:
bilinear at one shift per tile, from the edge-extended history, with the
fractions quantised to 1/FRAC_Q and the sample start clamped to
[-MARGIN, wp-1]. Kernel K4 does the resample:

    reproject_tiles   CUDA kernel csrc/tile_reproject.cu (CUDA tensors)
                      or reproject_tiles_plain (CPU tensors)

Replaces chord_tpu/ops/tile_reproject.py::_reproject_kernel (:55), whose
(32,48)@(48,256) and (32,256)@(256,128) one-hot matmuls fold the two
lerps over margin-padded planes. The kernel reads the (H,W,C) history at
clamped coordinates, which is the same data as chord_tpu's edge padding,
and writes the (H,W,C) output: no padded copy of the history is made on
the card. The plain version keeps the padded planes, an independent
formulation of the edge rule. The per-tile mean motion and the table of
per-tile offsets/fractions are plain torch, as in chord_tpu.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from ._util import f2i

TILE_H = 32
TILE_W = 128
WIN_H = 48
WIN_W = 256
MARGIN = 128
FRAC_Q = 1024


def _tile_table(motion_px: torch.Tensor, hp: int, wp: int):
    """Per-tile mean motion and [y0p, x0p, fy_q, fx_q] (padded-plane sample
    start + quantised fractions) -> (tm (ht,wt,2), tab (nt,4) i32)."""
    h, w = motion_px.shape[:2]
    ht, wt = hp // TILE_H, wp // TILE_W
    nt = ht * wt
    dev = motion_px.device
    mot = F.pad(motion_px.permute(2, 0, 1)[None], (0, wp - w, 0, hp - h),
                mode="replicate")[0].permute(1, 2, 0)
    tm = mot.reshape(ht, TILE_H, wt, TILE_W, 2).mean(dim=(1, 3))
    mx = tm[..., 0].reshape(nt)
    my = tm[..., 1].reshape(nt)
    ti = torch.arange(nt, dtype=torch.int32, device=dev)
    ty, tx = ti // wt, ti % wt
    sx = tx.to(torch.float32) * TILE_W + (0.5 - mx)
    sy = ty.to(torch.float32) * TILE_H + (0.5 - my)
    x0 = torch.floor(sx - 0.5)
    y0 = torch.floor(sy - 0.5)
    fx = sx - 0.5 - x0
    fy = sy - 0.5 - y0
    x0p = torch.clamp(f2i(x0), -MARGIN, wp - 1) + MARGIN
    y0p = torch.clamp(f2i(y0), -MARGIN, hp - 1) + MARGIN
    tab = torch.stack([y0p, x0p,
                       f2i(torch.round(fy * FRAC_Q)),
                       f2i(torch.round(fx * FRAC_Q))], 1).to(torch.int32)
    return tm, tab.contiguous()


def _tiles(h: int, w: int) -> Tuple[int, int]:
    """(hp, wp): the history size rounded up to whole 32x128 tiles."""
    return -(-h // TILE_H) * TILE_H, -(-w // TILE_W) * TILE_W


def reproject_tiles_plain(img: torch.Tensor, tab: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of kernel K4: history (h,w,C) x tab (nt,4) ->
    (h,w,C). Builds chord_tpu's margin-padded planes (C, MARGIN+hp+WIN_H,
    MARGIN+wp+WIN_W) by edge replication and reads the taps there."""
    h, w, c = img.shape
    hp, wp = _tiles(h, w)
    ht, wt = hp // TILE_H, wp // TILE_W
    planes = F.pad(img.permute(2, 0, 1)[None],
                   (MARGIN, wp - w + WIN_W, MARGIN, hp - h + WIN_H),
                   mode="replicate")[0]
    dev = img.device
    t = tab.long()
    fy = (tab[:, 2].to(torch.float32) * (1.0 / FRAC_Q))[:, None, None]
    fx = (tab[:, 3].to(torch.float32) * (1.0 / FRAC_Q))[:, None, None]
    yy = t[:, 0, None, None] + torch.arange(TILE_H, device=dev)[None, :, None]
    xx = t[:, 1, None, None] + torch.arange(TILE_W, device=dev)[None, None, :]
    pw = planes.shape[2]
    flat = planes.reshape(c, -1)

    def tap(dy, dx):
        return flat[:, ((yy + dy) * pw + xx + dx).reshape(-1)].reshape(
            c, -1, TILE_H, TILE_W)

    top = (1.0 - fy) * tap(0, 0) + fy * tap(1, 0)
    bot = (1.0 - fy) * tap(0, 1) + fy * tap(1, 1)
    out = (1.0 - fx) * top + fx * bot                       # (C,nt,TH,TW)
    return out.reshape(c, ht, wt, TILE_H, TILE_W).permute(
        1, 3, 2, 4, 0).reshape(hp, wp, c)[:h, :w]


def reproject_tiles(img: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Kernel K4 -> (h,w,C) reprojected history. CPU tensors ->
    reproject_tiles_plain; CUDA tensors -> csrc/tile_reproject.cu."""
    if not img.is_cuda:
        return reproject_tiles_plain(img, tab)
    if img.dim() != 3 or not 1 <= img.shape[2] <= 8:
        raise ValueError(f"img must be (h, w, C) with 1 <= C <= 8 (got "
                         f"{tuple(img.shape)})")
    if img.numel() >= 2 ** 31:
        raise ValueError("img must hold fewer than 2**31 values")
    h, w, c = img.shape
    hp, wp = _tiles(h, w)
    _cuda.check(img, "img", torch.float32)
    _cuda.check(tab, "tab", torch.int32,
                ((hp // TILE_H) * (wp // TILE_W), 4))
    out = torch.empty_like(img)
    ci = _cuda.cint
    _cuda.launch("chord_tile_reproject_hwc", _cuda.ptr(img), _cuda.ptr(tab),
                 ci(c), ci(h), ci(w), _cuda.ptr(out), _cuda.stream())
    reproject_tiles.launches += 1
    return out


reproject_tiles.launches = 0


def tile_reproject(img: torch.Tensor, motion_px: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (H,W,C) or (H,W) f32 history, motion_px (H,W,2) pixels (right,
    down; content came FROM pos - motion) -> (reprojected history,
    per-pixel residual in pixels vs the tile mean)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, _c = img.shape
    hp, wp = _tiles(h, w)
    tm, tab = _tile_table(motion_px, hp, wp)
    out = reproject_tiles(img.contiguous(), tab)
    if squeeze:
        out = out[..., 0]
    return out, residual(motion_px, tm)


def residual(motion_px: torch.Tensor, tm: torch.Tensor) -> torch.Tensor:
    """Per-pixel |motion - its tile's mean motion| (H,W), from the tile
    means tm (ht,wt,2) of _tile_table."""
    h, w = motion_px.shape[:2]
    ht, wt = tm.shape[:2]
    tile_m = tm[:, None, :, None, :].expand(ht, TILE_H, wt, TILE_W, 2
                                            ).reshape(ht * TILE_H,
                                                      wt * TILE_W, 2)[:h, :w]
    r = motion_px - tile_m
    return torch.sqrt(r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1])
