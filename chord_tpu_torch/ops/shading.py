"""Deferred shading from the visibility buffer (port of
chord_tpu/ops/shading.py: GBuffer, SunLight, the flat frame's
`resolve_gbuffer`, `resolve_gbuffer_raster_rt` with its textured branch,
`shade_pixels` with the shadow mask and the atmosphere's sky and ambient,
the masked bucket's alpha test and the blend bucket's forward shade;
reference lighting.hlsl:270-385).

The flat frame's resolve re-fetches each pixel's triangle from the flat
pools (payload - 1) and interpolates its vertices with perspective-correct
barycentrics. On the meshlet frame normals and uv come from the
rasterizer's attribute planes, position from
depth unprojection; material constants and the per-object rigid motion
delta are per-draw table rows fetched per pixel with kernel K3
(ops/row_gather.py); material maps are sampled with kernel K5
(ops/paged_texture.py via ops/texture.py). All radiometric quantities are
linear ACEScg.
"""

from __future__ import annotations

import math
import weakref
from typing import NamedTuple, Optional, Tuple

import torch

from . import colorspace, row_gather
from . import texture as texture_ops
from ._util import bits_f32, centres, dot3, fma_f32, norm3, rsqrt_rn
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


def _barycentrics_from_clip(c0, c1, c2, px_ndc, py_ndc):
    """Perspective-correct barycentrics (b0, b1, b2) at an NDC point from
    three (...,4) clip-space vertices: the 2D homogeneous cofactors at the
    point, normalised by their sum (chord_tpu shading.py:62-96)."""
    x0, y0, w0 = c0[..., 0], c0[..., 1], c0[..., 3]
    x1, y1, w1 = c1[..., 0], c1[..., 1], c1[..., 3]
    x2, y2, w2 = c2[..., 0], c2[..., 1], c2[..., 3]

    def edge(ax, ay, aw, bx, by, bw):
        return ((ay * bw - aw * by) * px_ndc + (aw * bx - ax * bw) * py_ndc +
                (ax * by - ay * bx))

    l0 = edge(x1, y1, w1, x2, y2, w2)
    l1 = edge(x2, y2, w2, x0, y0, w0)
    l2 = edge(x0, y0, w0, x1, y1, w1)
    s = l0 + l1 + l2
    inv = 1.0 / torch.where(torch.abs(s) > 1e-20, s,
                            torch.ones((), device=s.device))
    return l0 * inv, l1 * inv, l2 * inv


def rigid_delta(m: torch.Tensor, m_prev: torch.Tensor) -> torch.Tensor:
    """(O,4,4) f32 inv(m) @ m_prev, the per-object motion delta, rounded
    as chord_tpu's compiled jnp.linalg.inv and einsum (chord_tpu
    shading.py:200-201) round it on the CPU, and the same on every device
    (torch.linalg.inv is another LU, and on the card cuSOLVER's): the LU
    of OpenBLAS's sgetf2 (left-looking; the pivot the first largest |x|;
    its U rows' dots from the last term, its column update from the
    first, each a product then fused multiply-adds; the multipliers scaled by the pivot's f32 reciprocal),
    the two triangular solves of its strsm on the permuted identity
    (fused updates, the diagonal's reciprocal), then XLA's batched dot,
    a product then three fused multiply-adds. The fused steps go through
    fma_f32."""
    a = m.float().clone()
    o = a.shape[0]
    rows = torch.arange(o, device=a.device)
    piv = []
    for j in range(4):
        col = a[:, :, j].clone()
        for i, ip in enumerate(piv):       # the earlier row swaps
            vi, vp = col[:, i].clone(), col[rows, ip]
            col[:, i] = vp
            col[rows, ip] = vi
        for i in range(1, j):              # U: b_i -= dot(l_i, b)
            s = a[:, i, i - 1] * col[:, i - 1]
            for k in range(i - 2, -1, -1):
                s = fma_f32(a[:, i, k], col[:, k], s)
            col[:, i] = col[:, i] - s
        if j:                              # b[j:] -= L[j:, :j] @ b[:j]
            s = a[:, j:, 0] * col[:, 0:1]
            for k in range(1, j):
                s = fma_f32(a[:, j:, k], col[:, k:k + 1], s)
            col[:, j:] = col[:, j:] - s
        a[:, :, j] = col
        jp = j + torch.argmax(torch.abs(col[:, j:]), dim=1)
        piv.append(jp)
        rj, rp = a[:, j, :j + 1].clone(), a[rows, jp, :j + 1]
        a[:, j, :j + 1] = rp
        a[rows, jp, :j + 1] = rj
        a[:, j + 1:, j] = a[:, j + 1:, j] * (1.0 / a[:, j, j])[:, None]
    perm = torch.arange(4, device=a.device).repeat(o, 1)
    for i, ip in enumerate(piv):
        vi, vp = perm[:, i].clone(), perm[rows, ip]
        perm[:, i] = vp
        perm[rows, ip] = vi
    x = torch.eye(4, device=a.device)[perm]
    for i in range(3):                     # L (unit) forward
        x[:, i + 1:] = fma_f32(-a[:, i + 1:, i:i + 1], x[:, i:i + 1],
                               x[:, i + 1:])
    for i in range(3, -1, -1):             # U backward
        x[:, i] = x[:, i] * (1.0 / a[:, i, i])[:, None]
        if i:
            x[:, :i] = fma_f32(-a[:, :i, i:i + 1], x[:, i:i + 1], x[:, :i])
    b = m_prev.float()
    d = x[:, :, 0:1] * b[:, None, 0] + 0.0       # its sum starts at +0
    for k in range(1, 4):
        d = fma_f32(x[:, :, k:k + 1], b[:, None, k], d)
    return d


_DELTA_MEMO: dict = {}


def motion_delta(m: torch.Tensor, m_prev: torch.Tensor) -> torch.Tensor:
    """rigid_delta of an instance table's matrices, made once for a pair of
    tensors: a sequence's frames share one table, and the delta's ~400
    small operations then run on its first frame only. Another tensor, or
    one changed in place (its version counter moves), makes it anew."""
    key = (m._version, m_prev._version)
    last = _DELTA_MEMO.get("last")
    if last is not None and last[0]() is m and last[1]() is m_prev and \
            last[2] == key:
        return last[3]
    d = rigid_delta(m, m_prev)
    _DELTA_MEMO["last"] = (weakref.ref(m), weakref.ref(m_prev), key, d)
    return d


def resolve_gbuffer(vis, pools, instances, view_tw_to_clip: torch.Tensor,
                    prev_tw_to_clip: torch.Tensor) -> GBuffer:
    """Visibility (payload = flat pool triangle + 1, 0 = sky) -> g-buffer
    (chord_tpu shading.py:99-120)."""
    tri = vis.long() - 1
    valid = tri >= 0
    tri_safe = torch.clamp_min(tri, 0)
    return _resolve_from_ids(pools.indices[tri_safe].long(),
                             pools.tri_object[tri_safe].long(), valid, pools,
                             instances, view_tw_to_clip, prev_tw_to_clip)


def _resolve_from_ids(idx, obj, valid, pools, instances,
                      view_tw_to_clip: torch.Tensor,
                      prev_tw_to_clip: torch.Tensor) -> GBuffer:
    """Per pixel: its triangle's pool vertices `idx` (H,W,3) and object
    `obj` (H,W) -> interpolated position, normal, uv, per-object motion
    (object_prev_to_tw) and material constants (chord_tpu
    shading.py:566-663)."""
    h, w = valid.shape
    dev = valid.device
    p = [pools.positions[idx[..., k]] for k in range(3)]   # (H,W,3) local
    n = [pools.normals[idx[..., k]] for k in range(3)]
    t = [pools.uv0[idx[..., k]] for k in range(3)]
    m = instances.object_to_tw[obj]                         # (H,W,4,4)
    mp = instances.object_prev_to_tw[obj]
    nm = instances.object_normal_mat[obj]                   # (H,W,3,3)

    def xf(q, mat):   # row vector: q' = (q, 1) @ mat
        return (q[..., 0:1] * mat[..., 0, :] + q[..., 1:2] * mat[..., 1, :] +
                q[..., 2:3] * mat[..., 2, :] + mat[..., 3, :])

    def clip_of(q, vp):
        return (q[..., 0:1] * vp[0] + q[..., 1:2] * vp[1] +
                q[..., 2:3] * vp[2] + q[..., 3:4] * vp[3])

    tw = [xf(q, m) for q in p]
    c = [clip_of(q, view_tw_to_clip) for q in tw]
    # pixel-centre NDC (y up in NDC, y down in pixels)
    xs = centres(w, dev) * 2.0 - 1.0
    ys = 1.0 - centres(h, dev) * 2.0
    b0, b1, b2 = _barycentrics_from_clip(c[0], c[1], c[2],
                                         xs[None, :].expand(h, w),
                                         ys[:, None].expand(h, w))
    b0, b1, b2 = b0[..., None], b1[..., None], b2[..., None]
    interp = lambda v0, v1, v2: b0 * v0 + b1 * v1 + b2 * v2
    pos_tw = interp(tw[0][..., :3], tw[1][..., :3], tw[2][..., :3])
    nl = interp(*n)
    nrm = (nl[..., 0:1] * nm[..., 0, :] + nl[..., 1:2] * nm[..., 1, :] +
           nl[..., 2:3] * nm[..., 2, :])
    nrm = nrm / torch.clamp_min(norm3(nrm, keepdim=True), 1e-8)
    uv = interp(*t)
    # motion: NDC delta of the interpolated point between frames
    prev = [xf(q, mp) for q in p]
    prev_pos = interp(prev[0][..., :3], prev[1][..., :3], prev[2][..., :3])

    def project_ndc(q, vp):
        cc = (q[..., 0:1] * vp[0] + q[..., 1:2] * vp[1] +
              q[..., 2:3] * vp[2] + vp[3])
        return cc[..., :2] / torch.clamp_min(torch.abs(cc[..., 3:4]),
                                             1e-8) * torch.sign(cc[..., 3:4])

    motion = (project_ndc(pos_tw, view_tw_to_clip) -
              project_ndc(prev_pos, prev_tw_to_clip))
    mat_id = instances.object_material[obj].long()
    base = colorspace.srgb_to_acescg(pools.mat_base_color[mat_id][..., :3])
    metal_rough = pools.mat_metal_rough[mat_id]
    emissive = colorspace.srgb_to_acescg(pools.mat_emissive[mat_id])
    vz = valid[..., None]
    zero = torch.zeros((), device=dev)
    return GBuffer(
        valid=valid,
        position_tw=torch.where(vz, pos_tw, zero),
        normal=torch.where(vz, nrm, zero),
        base_color=torch.where(vz, base, zero),
        metallic=torch.where(valid, metal_rough[..., 0], zero),
        roughness=torch.where(valid, metal_rough[..., 1],
                              torch.ones((), device=dev)),
        emissive=torch.where(vz, emissive, zero),
        uv=torch.where(vz, uv, zero),
        motion=torch.where(vz, motion, zero),
    )


def resolve_gbuffer_raster_rt(
    vis, depth, nx, ny, nz, u, v, draw_object, pools, instances,
    clip_to_tw, tw_to_clip, prev_tw_to_clip, textured: bool = False,
    normal_mapped: bool = False, pbr_textures: bool = False,
    mip_dither_frame=None, motion_div: int = 1,
) -> GBuffer:
    """Visibility + raster attribute planes -> g-buffer.

    Motion is per object: the pixel's previous position is rebuilt through
    the draw's rigid delta inv(M) @ M_prev, fetched per pixel at 1/motion_div
    resolution and nearest-upsampled; misses take the identity (pure camera
    reprojection). `textured` multiplies the base colour by its map;
    `pbr_textures` adds the metal-rough (G = roughness, B = metallic) and
    emissive maps, `normal_mapped` the tangent-space normal map; all maps
    of a pixel come from one K5 pass. `mip_dither_frame` (a frame counter)
    switches to the stochastic-trilinear mip."""
    from . import post

    h, w = vis.shape
    dev = vis.device
    slot, _tri = unpack_visibility(vis)
    valid = slot >= 0

    inv_len = rsqrt_rn(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-12))
    nrm = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    uv = torch.stack([u, v], dim=-1)

    xs = centres(w, dev) * 2.0 - 1.0
    ys = 1.0 - centres(h, dev) * 2.0
    px = xs[None, :].expand(h, w)
    py = ys[:, None].expand(h, w)
    ph = (px[..., None] * clip_to_tw[0] + py[..., None] * clip_to_tw[1] +
          depth[..., None] * clip_to_tw[2] + clip_to_tw[3])
    one = torch.ones((), device=dev)
    pos_tw = ph[..., :3] / torch.where(torch.abs(ph[..., 3:4]) > 1e-12,
                                       ph[..., 3:4], one)

    delta = motion_delta(instances.object_to_tw, instances.object_prev_to_tw)
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
    if textured:
        base, metal, rough, emissive, nrm = _textured_maps(
            pools, mplanes, slot, valid, uv, pos_tw, nrm, base, metal, rough,
            emissive, normal_mapped, pbr_textures, mip_dither_frame)

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


def _textured_maps(pools, mplanes, slot, valid, uv, pos_tw, nrm, base, metal,
                   rough, emissive, normal_mapped: bool, pbr_textures: bool,
                   mip_dither_frame):
    """The textured branch of the resolve (chord_tpu shading.py:257-332):
    one K5 pass over [base, (mr, emissive), (normal)] layer planes ->
    (base, metal, rough, emissive, normal)."""
    size = pools.tex_size
    if mip_dither_frame is not None:
        mip = texture_ops.mip_dithered(uv, size, mip_dither_frame)
    else:
        mip = texture_ops.mip_from_uv_density(uv, size)
    layer_list = [mplanes[8]]
    if pbr_textures:
        layer_list += [mplanes[10], mplanes[11]]
    if normal_mapped:
        layer_list.append(mplanes[9])
    texels = texture_ops.sample_material_maps(pools, torch.stack(layer_list),
                                              uv, mip)
    # maps are stored with linear-sRGB primaries; convert to AP1
    base = base * colorspace.srgb_to_acescg(texels[0][..., :3])
    if pbr_textures:
        metal = metal * texels[1][..., 2]
        rough = rough * texels[1][..., 1]
        emissive = emissive * colorspace.srgb_to_acescg(texels[2][..., :3])
    if normal_mapped:
        nrm = _normal_map(nrm, texels[-1], layer_list[-1], bits_f32(
            mplanes[12])[..., None], slot, valid, uv, pos_tw)
    return base, metal, rough, emissive, nrm


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, as jnp.cross computes it (a1 b2 - a2 b1,
    ...; torch.linalg.cross rounds otherwise)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normal_map(nrm, n_texel, n_layer, n_scale, slot, valid, uv, pos_tw):
    """Tangent-space normal mapping without stored tangents: the cotangent
    frame from screen-space differences of position and uv (Schüler's
    method), masked to same-surface neighbours so silhouettes keep the
    geometric normal. Row differences run y-down, which flips both frame
    vectors; the flipped cross orders restore glTF's +u/+v handedness."""
    n_ts = n_texel[..., :3] * 2.0 - 1.0
    ddx = lambda a: a - torch.roll(a, 1, dims=1)
    ddy = lambda a: a - torch.roll(a, 1, dims=0)
    same_x = (slot == torch.roll(slot, 1, dims=1)) & valid
    same_y = (slot == torch.roll(slot, 1, dims=0)) & valid
    zero = torch.zeros((), device=nrm.device)
    dp1 = torch.where(same_x[..., None], ddx(pos_tw), zero)
    dp2 = torch.where(same_y[..., None], ddy(pos_tw), zero)
    du1 = torch.where(same_x[..., None], ddx(uv), zero)
    du2 = torch.where(same_y[..., None], ddy(uv), zero)
    dp2perp = _cross(nrm, dp2)
    dp1perp = _cross(dp1, nrm)
    t = dp2perp * du1[..., 0:1] + dp1perp * du2[..., 0:1]
    b = dp2perp * du1[..., 1:2] + dp1perp * du2[..., 1:2]
    m2 = torch.maximum(dot3(t, t), dot3(b, b))
    inv = rsqrt_rn(torch.clamp_min(m2, 1e-24))[..., None]
    pert = (t * inv * (n_ts[..., 0:1] * n_scale) +
            b * inv * (n_ts[..., 1:2] * n_scale) +
            nrm * torch.clamp_min(n_ts[..., 2:3], 0.05))
    pert = pert * rsqrt_rn(torch.clamp_min(
        dot3(pert, pert)[..., None], 1e-12))
    ok = (n_layer >= 0) & (m2 > 1e-24) & same_x & same_y
    return torch.where(ok[..., None], pert, nrm)


def alpha_mask_accept(vis_m, depth_m, depth_o, u_m, v_m, draw_object_m,
                      payload_base: int, pools, instances) -> torch.Tensor:
    """Deferred punch-through of the masked bucket (the reference's Masked
    raster permutation discards in the pixel shader): a masked fragment
    survives where it hit, lies in front of the opaque layer and passes
    its alpha test. One masked layer: a masked surface behind a failing
    texel falls back to the opaque layer."""
    hit, keep = masked_alpha_keep(vis_m, u_m, v_m, draw_object_m,
                                  payload_base, pools, instances)
    return hit & (depth_m > depth_o) & keep


def masked_alpha_keep(vis_m, u_m, v_m, draw_object_m, payload_base: int,
                      pools, instances) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel masked alpha test -> (hit, alpha >= cutoff): the draw's
    [cutoff, base alpha, base layer] row via K3, the base map's alpha via
    K5 with NEAREST taps (the test is binary; bilinear would only shift
    the cutoff crossing by under a texel)."""
    slot_g, _tri = unpack_visibility(vis_m)
    slot = slot_g - payload_base
    hit = slot_g >= 0
    slot_safe = torch.where(hit, torch.clamp_min(slot, 0),
                            torch.zeros_like(slot))
    mat_d = instances.object_material[draw_object_m.long()].long()
    cm = pack_table([pools.mat_alpha_cutoff[mat_d],
                     pools.mat_base_color[mat_d][:, 3],
                     pools.mat_base_tex[mat_d]])
    rows = row_gather.gather_rows(cm, slot_safe.contiguous())
    cutoff, factor, layer = bits_f32(rows[0]), bits_f32(rows[1]), rows[2]
    uv = torch.stack([u_m, v_m], dim=-1)
    mip = texture_ops.mip_from_uv_density(uv, pools.tex_size)
    texel = texture_ops.sample_material_maps(pools, layer[None], uv, mip,
                                             bilinear=False)[0]
    alpha = factor * torch.where(layer >= 0, texel[..., 3],
                                 torch.ones((), device=texel.device))
    return hit, alpha >= cutoff


def shade_blend_layer(vis_b, depth_b, depth_o, nx, ny, nz, u_b, v_b,
                      draw_object_b, pools, instances, sun: SunLight,
                      sun_shadow: Optional[torch.Tensor] = None,
                      ambient: Optional[torch.Tensor] = None,
                      textured: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-shade ONE depth-peeled translucent layer (the glTF Blend
    bucket; the rasterizer's closest-fragment rule is the peel) ->
    (colour (H,W,3) AP1, alpha (H,W)), composited by the caller with
    src-alpha blending. `textured=False` skips the base-map sample (no
    blend material of the scene carries one)."""
    slot, _tri = unpack_visibility(vis_b)
    hit = (slot >= 0) & (depth_b > depth_o)      # in front of opaque
    slot_safe = torch.clamp_min(slot, 0)
    mat_d = instances.object_material[draw_object_b.long()].long()
    base_b = colorspace.srgb_to_acescg(pools.mat_base_color[mat_d][:, :3])
    em_b = colorspace.srgb_to_acescg(pools.mat_emissive[mat_d])
    cm = pack_table([base_b[:, 0], base_b[:, 1], base_b[:, 2],
                     pools.mat_base_color[mat_d][:, 3],
                     em_b[:, 0], em_b[:, 1], em_b[:, 2],
                     pools.mat_base_tex[mat_d]])
    rows = row_gather.gather_rows(cm, slot_safe.contiguous())
    fb = lambda c: bits_f32(rows[c])
    alpha = fb(3)
    albedo = torch.stack([fb(0), fb(1), fb(2)], -1)
    emissive = torch.stack([fb(4), fb(5), fb(6)], -1)
    layer = rows[7]
    one = torch.ones((), device=alpha.device)
    if textured:
        uv = torch.stack([u_b, v_b], dim=-1)
        mip = texture_ops.mip_from_uv_density(uv, pools.tex_size)
        texel = texture_ops.sample_material_maps(pools, layer[None], uv,
                                                 mip)[0]
        has_tex = (layer >= 0)[..., None]
        albedo = torch.where(
            has_tex, albedo * colorspace.srgb_to_acescg(texel[..., :3]),
            albedo)
        alpha = alpha * torch.where(layer >= 0, texel[..., 3], one)

    n = torch.stack([nx, ny, nz], dim=-1)
    n = n / torch.clamp_min(_norm3(n), 1e-6)
    ndl = torch.clamp((n * sun.direction).sum(-1), 0.0, 1.0)
    lit = ndl if sun_shadow is None else ndl * sun_shadow
    amb = (ambient if ambient is not None
           else sun.sky_ambient[None, None, :] * 0.5)
    color = albedo * (sun.radiance * lit[..., None] / math.pi + amb) + \
        emissive
    alpha = torch.where(hit, torch.clamp(alpha, 0.0, 1.0),
                        torch.zeros((), device=alpha.device))
    return color, alpha


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return norm3(x, keepdim=True)


def shade_pixels(g: GBuffer, sun: SunLight,
                 sun_shadow: Optional[torch.Tensor] = None,
                 ambient: Optional[torch.Tensor] = None,
                 sky_radiance: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel sun (GGX, height-correlated Smith, Schlick) with the
    optional (H,W) shadow mask + ambient (the atmosphere's, else a flat
    hemispherical sky term) -> (H,W,3) HDR AP1. Misses take `sky_radiance`
    (H,W,3), else the flat sky colour."""
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
    sky = (sky_radiance if sky_radiance is not None
           else sun.sky_ambient.expand_as(lit))
    return torch.where(g.valid[..., None], lit, sky)
