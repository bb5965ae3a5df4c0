"""Deferred shading from the visibility buffer (port of
chord_tpu/ops/shading.py: GBuffer, SunLight, the untextured
`resolve_gbuffer_raster_rt` and `shade_pixels`; reference
lighting.hlsl:270-385).

Normals and uv come from the rasterizer's attribute planes, position from
depth unprojection; material constants and the per-object rigid motion
delta are per-draw table rows fetched per pixel with kernel K3
(ops/row_gather.py). All radiometric quantities are linear ACEScg.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import colorspace
from ._util import bits_f32
from . import row_gather
from .row_gather import pack_table
from ..rhi.framebuffer import unpack_visibility


class SunLight(NamedTuple):
    """Directional sun: direction points from the surface TOWARD the sun
    (translated world); radiance and sky ambient in AP1."""

    direction: torch.Tensor    # (3,)
    radiance: torch.Tensor     # (3,)
    sky_ambient: torch.Tensor  # (3,)


class GBuffer(NamedTuple):
    """Decoded per-pixel surface attributes."""

    valid: torch.Tensor        # (H,W) bool
    position_tw: torch.Tensor  # (H,W,3)
    normal: torch.Tensor       # (H,W,3)
    base_color: torch.Tensor   # (H,W,3) AP1 linear albedo
    metallic: torch.Tensor     # (H,W)
    roughness: torch.Tensor    # (H,W)
    emissive: torch.Tensor     # (H,W,3)
    uv: torch.Tensor           # (H,W,2)
    motion: torch.Tensor       # (H,W,2) NDC motion (curr - prev)


def _project_xy(p3: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    c = (p3[..., 0:1] * vp[0] + p3[..., 1:2] * vp[1] +
         p3[..., 2:3] * vp[2] + vp[3])
    wc = torch.where(torch.abs(c[..., 3:4]) > 1e-8, c[..., 3:4],
                     torch.ones((), device=c.device))
    return c[..., :2] / wc


def resolve_gbuffer_raster_rt(
    vis, depth, nx, ny, nz, u, v, draw_object, pools, instances,
    clip_to_tw, tw_to_clip, prev_tw_to_clip, motion_div: int = 1,
) -> GBuffer:
    """Visibility + raster attribute planes -> g-buffer (untextured).

    Motion is per object: the pixel's previous position is rebuilt through
    the draw's rigid delta inv(M) @ M_prev, fetched per pixel at 1/motion_div
    resolution and nearest-upsampled; misses take the identity (pure camera
    reprojection)."""
    from . import post

    h, w = vis.shape
    dev = vis.device
    slot, _tri = unpack_visibility(vis)
    valid = slot >= 0

    inv_len = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-12))
    nrm = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    uv = torch.stack([u, v], dim=-1)

    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0
    px = xs[None, :].expand(h, w)
    py = ys[:, None].expand(h, w)
    ph = (px[..., None] * clip_to_tw[0] + py[..., None] * clip_to_tw[1] +
          depth[..., None] * clip_to_tw[2] + clip_to_tw[3])
    one = torch.ones((), device=dev)
    pos_tw = ph[..., :3] / torch.where(torch.abs(ph[..., 3:4]) > 1e-12,
                                       ph[..., 3:4], one)

    minv = torch.linalg.inv(instances.object_to_tw)
    delta = torch.matmul(minv, instances.object_prev_to_tw)
    delta_d = delta[draw_object.long()].reshape(-1, 16)
    if motion_div > 1:
        slot_m = post.decimate(slot, motion_div)
        valid_m = post.decimate(valid, motion_div)
        pos_m = post.decimate(pos_tw, motion_div)
    else:
        slot_m, valid_m, pos_m = slot, valid, pos_tw
    dpl = row_gather.gather_rows(pack_table([delta_d[:, i] for i in range(16)]),
                      slot_m.contiguous())
    d = lambda i: bits_f32(dpl[i])
    px_, py_, pz_ = pos_m[..., 0], pos_m[..., 1], pos_m[..., 2]
    prev_pos = torch.stack(
        [px_ * d(0) + py_ * d(4) + pz_ * d(8) + d(12),
         px_ * d(1) + py_ * d(5) + pz_ * d(9) + d(13),
         px_ * d(2) + py_ * d(6) + pz_ * d(10) + d(14)], -1)
    prev_pos = torch.where(valid_m[..., None], prev_pos, pos_m)
    motion = _project_xy(pos_m, tw_to_clip) - _project_xy(prev_pos,
                                                          prev_tw_to_clip)
    if motion_div > 1:
        motion = post.upsample_nearest(motion, motion_div, h, w)

    # one per-pixel row fetch from the per-draw material table (the
    # texture-id channels 8-12 ride along for the textured slice)
    mat_id = instances.object_material[draw_object.long()].long()
    base_d = colorspace.srgb_to_acescg(pools.mat_base_color[mat_id][..., :3])
    mr_d = pools.mat_metal_rough[mat_id]
    em_d = colorspace.srgb_to_acescg(pools.mat_emissive[mat_id])
    cm = pack_table([
        base_d[:, 0], base_d[:, 1], base_d[:, 2], mr_d[:, 0], mr_d[:, 1],
        em_d[:, 0], em_d[:, 1], em_d[:, 2],
        pools.mat_base_tex[mat_id], pools.mat_normal_tex[mat_id],
        pools.mat_mr_tex[mat_id], pools.mat_emissive_tex[mat_id],
        pools.mat_normal_scale[mat_id]])
    mplanes = row_gather.gather_rows(cm, slot.contiguous())
    f = lambda c: bits_f32(mplanes[c])
    base = torch.stack([f(0), f(1), f(2)], -1)
    metal, rough = f(3), f(4)
    emissive = torch.stack([f(5), f(6), f(7)], -1)

    vz = valid[..., None]
    zero = torch.zeros((), device=dev)
    return GBuffer(
        valid=valid,
        position_tw=torch.where(vz, pos_tw, zero),
        normal=torch.where(vz, nrm, zero),
        base_color=torch.where(vz, base, zero),
        metallic=torch.where(valid, metal, zero),
        roughness=torch.where(valid, rough, one),
        emissive=torch.where(vz, emissive, zero),
        uv=torch.where(vz, uv, zero),
        motion=torch.where(vz, motion, zero),
    )


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def shade_pixels(g: GBuffer, sun: SunLight,
                 sun_shadow: Optional[torch.Tensor] = None,
                 ambient: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel sun (GGX, height-correlated Smith, Schlick) + flat
    hemispherical sky ambient -> (H,W,3) HDR AP1; misses take the sky."""
    n = g.normal
    vv = -g.position_tw
    vv = vv / torch.clamp_min(_norm3(vv), 1e-8)
    l = sun.direction.expand_as(n)
    hh = vv + l
    hh = hh / torch.clamp_min(_norm3(hh), 1e-8)
    nol = torch.clamp((n * l).sum(-1), 0.0, 1.0)
    nov = torch.clamp((n * vv).sum(-1), 1e-4, 1.0)
    noh = torch.clamp((n * hh).sum(-1), 0.0, 1.0)
    voh = torch.clamp((vv * hh).sum(-1), 0.0, 1.0)

    a = torch.clamp_min(g.roughness * g.roughness, 1e-3)
    a2 = a * a
    met = g.metallic[..., None]
    f0 = 0.04 * (1.0 - met) + g.base_color * met
    diffuse_color = g.base_color * (1.0 - met)

    dd = noh * noh * (a2 - 1.0) + 1.0
    d_ggx = a2 / torch.clamp_min(math.pi * dd * dd, 1e-8)
    ggx_v = nol * torch.sqrt(torch.clamp_min(nov * nov * (1.0 - a2) + a2, 1e-8))
    ggx_l = nov * torch.sqrt(torch.clamp_min(nol * nol * (1.0 - a2) + a2, 1e-8))
    vis = 0.5 / torch.clamp_min(ggx_v + ggx_l, 1e-8)
    fres = f0 + (1.0 - f0) * torch.pow(
        torch.clamp(1.0 - voh[..., None], 0.0, 1.0), 5.0)
    specular = (d_ggx * vis)[..., None] * fres
    diffuse = diffuse_color / math.pi
    shadow = sun_shadow if sun_shadow is not None else 1.0
    direct = (diffuse + specular) * (nol * shadow)[..., None] * sun.radiance
    if ambient is None:
        up_wrap = torch.clamp(n[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
        ambient = sun.sky_ambient * up_wrap
    lit = direct + diffuse_color * ambient + g.emissive
    sky = sun.sky_ambient.expand_as(lit)
    return torch.where(g.valid[..., None], lit, sky)
