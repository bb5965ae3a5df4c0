"""Material texture sampling from the stacked flat-mip pool (port of
chord_tpu/ops/texture.py; reference: bindless material sampling in
lighting.hlsl with ddx/ddy-derived mips).

`sample_material_maps` is the frame's path: one fused pass of kernel K5
(ops/paged_texture.py) over every material map of a pixel. `sample_pool`
is the plain per-layer gather over the raw u8 pool, kept as the oracle
the tests hold the paged sampler's palette hits against. The mip comes
from screen-space uv differences (`mip_from_uv_density`), or is dithered
between two levels by interleaved gradient noise (`mip_dithered`,
stochastic trilinear).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import paged_texture
from ._util import f2i


def mip_chain(size: int) -> Tuple[List[int], List[int]]:
    """Edge size and flat offset of each mip of a (size, size) layer."""
    sizes, offsets = [], []
    off, s = 0, size
    while s >= 1:
        sizes.append(s)
        offsets.append(off)
        off += s * s
        s //= 2
    return sizes, offsets


def sample_pool(pool: torch.Tensor, mip_sizes, mip_offsets,
                layer: torch.Tensor, uv: torch.Tensor, mip: torch.Tensor,
                bilinear: bool = True) -> torch.Tensor:
    """(L, total, 4) u8 pool, (...) layer (-1 = untextured), (...,2) uv,
    (...) mip -> (...,4) f32 RGBA; untextured returns 1."""
    dev = layer.device
    n_mips = len(mip_sizes)
    m = torch.clamp(mip, 0, n_mips - 1).long()
    s = torch.tensor(list(mip_sizes), dtype=torch.int32, device=dev)[m]
    off = torch.tensor(list(mip_offsets), dtype=torch.int32, device=dev)[m]
    l_safe = torch.clamp_min(layer, 0).long()
    sf = s.float()
    u = torch.remainder(uv[..., 0], 1.0) * sf
    v = torch.remainder(uv[..., 1], 1.0) * sf
    scale = (1.0 / 255.0) if pool.dtype == torch.uint8 else 1.0

    def tex(xi, yi):
        xi = torch.minimum(torch.clamp_min(xi, 0), s - 1)
        yi = torch.minimum(torch.clamp_min(yi, 0), s - 1)
        return pool[l_safe, (off + yi * s + xi).long()].float() * scale

    if not bilinear:
        out = tex(f2i(u), f2i(v))
    else:
        x0 = torch.floor(u - 0.5)
        y0 = torch.floor(v - 0.5)
        fx = (u - 0.5 - x0)[..., None]
        fy = (v - 0.5 - y0)[..., None]
        x0i, y0i = f2i(x0), f2i(y0)
        out = (tex(x0i, y0i) * (1 - fx) * (1 - fy) +
               tex(x0i + 1, y0i) * fx * (1 - fy) +
               tex(x0i, y0i + 1) * (1 - fx) * fy +
               tex(x0i + 1, y0i + 1) * fx * fy)
    return torch.where((layer >= 0)[..., None], out,
                       torch.ones((), device=dev))


def sample_material_maps(pools, layers: torch.Tensor, uv: torch.Tensor,
                         mip: torch.Tensor, bilinear: bool = True
                         ) -> torch.Tensor:
    """Fused multi-channel material fetch through kernel K5:
    (C,H,W) i32 layers, (H,W,2) uv, (H,W) mip -> (C,H,W,4) f32, with
    chord_tpu's palette: 16-row blocks, 16 pages for the fused maps, 10
    for a single one (chord_tpu/ops/texture.py:93-96)."""
    mip_sizes, _ = mip_chain(pools.tex_size)
    packed = paged_texture.paged_sample(
        pools.tex_pages, pools.tex_meta, len(mip_sizes), mip_sizes,
        layers.contiguous(), uv.contiguous(), mip.contiguous(),
        bilinear=bilinear, block_h=16,
        k_pages=10 if layers.shape[0] == 1 else 16)
    return paged_texture.unpack_rgba(packed)


def mip_level_from_uv_density(uv: torch.Tensor, base_size: int
                              ) -> torch.Tensor:
    """Fractional mip level from screen-space uv differences (shifted
    differences stand in for the reference's ddx/ddy): log2 of the larger
    texel footprint, clamped to [0, 31]."""
    du = torch.abs(uv - torch.roll(uv, 1, dims=1))
    dv = torch.abs(uv - torch.roll(uv, 1, dims=0))
    d = torch.maximum(du.amax(-1), dv.amax(-1)) * base_size
    return torch.clamp(torch.log2(torch.clamp_min(d, 1.0)), 0.0, 31.0)


def mip_from_uv_density(uv: torch.Tensor, base_size: int) -> torch.Tensor:
    """Integer (floor) mip level — the single-mip bilinear default."""
    return mip_level_from_uv_density(uv, base_size).to(torch.int32)


def mip_dithered(uv: torch.Tensor, base_size: int, frame) -> torch.Tensor:
    """Stochastic trilinear: per pixel floor(level) or floor + 1 with
    probability frac(level), thresholded by interleaved gradient noise
    (TSR's accumulation resolves it to the trilinear blend)."""
    from .bluenoise import interleaved_gradient_noise

    lvl = mip_level_from_uv_density(uv, base_size)
    base = torch.floor(lvl)
    frac = lvl - base
    noise = interleaved_gradient_noise(uv.shape[0], uv.shape[1], frame,
                                       device=uv.device)
    return (base + (noise < frac).float()).to(torch.int32)
