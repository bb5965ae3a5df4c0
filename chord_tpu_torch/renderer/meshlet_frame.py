"""The GPU-driven meshlet frame (port of chord_tpu/renderer/meshlet_frame.py:
every branch of chord_tpu's frame). That is geometry with or without
two-phase HZB occlusion and the object pre-cull; material maps, the
alpha-masked bucket (one layer, or two with the masked depth peel) and
the blend bucket; cascaded shadow maps with
PCSS and the temporal shadow mask (inline, or pipelined: the frame exports
the PCSS inputs and shadow_service_step refreshes the cascade, evaluates
and blends after it, one frame late), the physically based sky and aerial
perspective; screen-probe GI (its samples from the neighbour taps or the
probe march), DDGI probe volumes or the world-cache GI, SSAO or RTAO, the
specular chain and SSR, and with gi_rt the BVH rays (probe rays beside
the screen samples, and SSR's misses), traced over the SceneBVH (sphere
proxies or triangle-exact leaves) that the caller passes as `bvh`, as
chord_tpu's frame takes it (DDGI and RTAO trace it too);
the debug views; TSR in the gather, global and tile modes, with or without
the render->post upscale, or a nearest upsample without TSR; the sRGB and
HDR10 outputs).

Pass order (chord_tpu meshlet_frame.py:470-1166; reference
renderer.cpp:316-343 and mesh_raster.cpp:269-330):
[cull.object_precull] -> cull.phase0 (vs last frame's HZB) ->
raster.phase0 -> hzb.mid -> cull.phase1 (the occluded remainder vs the
fresh HZB) -> raster.phase1 (seeded with phase 0) (without occlusion: one
cull and one raster) -> hzb.final [+ hzb.depth_range] -> [masked.cull ->
masked.raster -> masked.accept [-> masked.peel]] -> gbuffer_resolve
(textured or not) -> tsr.prepare + disocclusion_mask -> [atmosphere.sky]
-> [shadow.cascade_fit -> shadow.render (one cascade, round robin, scrolled
cache, alpha-tested masked casters) -> shadow.evaluate (PCSS, kernel K6)
-> shadow.temporal -> shadow.upsample] -> [gi.ao (SSAO, or RTAO with a
BVH) -> gi.probe.spawn -> gi.probe.sh_reproject -> [gi.probe.rt_trace] ->
gi.probe.taps (or gi.probe.trace, the march) -> gi.probe.project_sh ->
gi.probe.world_inject -> gi.probe.interpolate -> gi.probe.history_reproject
(K4) -> gi.probe.spatial_filter -> gi.probe.upsample (gi.ddgi.update ->
gi.ddgi.sample in ddgi mode, gi.sample in cache mode) -> gi.specular (SSR
[-> gi.specular.rt]) -> gi.specular.filter] -> lighting -> [blend.cull
-> blend.raster -> blend.shade] -> [atmosphere.aerial] -> [gi.inject,
cache and ddgi modes] -> auto_exposure -> [debug_visualize] -> tsr
(temporal_upscale when the post size differs from the render size,
temporal_resolve when equal; tile mode reprojects through K4) -> bloom ->
tonemap. With
alpha_masked the occlusion phases take the opaque bucket only. The GI
stages run inside torch.profiler.record_function spans named as
chord_tpu's named_scopes.

RendererConfig.subtiles is read only by the flat frame's
rasterize() and is ignored here, as in chord_tpu. The r.raster.bricks cvar
switches every main-view raster (both phases, the masked bucket and its
peel, the blend bucket) from K1 to K7; the shadow cascades build their
own config and keep K1. A frame is plain eager PyTorch around the kernels
(K1 or K7 raster, K2 mesh shader, K3 row gather, K4 tile reproject (tile
TSR, and the GI diffuse history), K5 paged texture sampler, K6 PCSS); the
BVH rays are plain tensor code (ops/rt.py), as in chord_tpu. Counts and
overflows stay on the device until the caller reads them. The shadow pass
and GI need the frame counter on the host (which cascade refreshes, which
PCSS phase runs, which cache cascade takes the probes, which DDGI probe
slice updates): render_frame_meshlet takes it as `frame_index`, which the
sequence runner reads once per call and MeshletRenderer once per render()
(one synchronisation each).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import atmosphere as atm
from ..ops import brdf_lut as brdf
from ..ops import colorspace, post, shading
from ..ops import ddgi as ddgi_ops
from ..ops import gi as gi_ops
from ..ops import rt
from ..ops import screen_probe as sp
from ..ops import ssr as ssr_ops
from ..ops._util import centres, const, dot3, f2i, norm3
from ..ops.bluenoise import interleaved_gradient_noise
from ..ops.cull import build_active_pairs, cull_pairs
from ..ops.hzb import HZBPyramid, build_hzb, hzb_layout, valid_depth_range
from ..ops.mesh_shader import mesh_shader_setup
from ..ops.raster import RasterConfig, bin_windows, raster_queue
from ..ops.shadow import (ShadowConfig, evaluate_shadow_auto,
                          fit_cascades_device)
from ..rhi.framebuffer import FrameHistory, unpack_visibility
from ..utils.collectives import all_reduce_mean
from ..utils.cvar import cvars
from .deferred import DeviceView, RendererConfig


class MeshletFrameConfig(NamedTuple):
    """chord_tpu MeshletFrameConfig's fields, with its defaults. The port
    runs every flag."""

    draw_capacity: int = 4096
    occlusion: bool = True
    lod_threshold_px: float = 1.0
    object_precull: bool = True
    active_pair_capacity: int = 0   # 0 = auto (min(P, max(16384, 4*cap)))
    shadows: bool = False           # cascaded shadow maps + PCSS
    shadow_cfg: ShadowConfig = ShadowConfig()
    shadow_draw_capacity: int = 2048
    # shadow maps take a coarser Nanite cut than the main view
    shadow_lod_scale: float = 4.0
    atmosphere: bool = False        # physically based sky / sun / ambient
    gi: bool = False                # diffuse GI + SSAO + specular GI
    # "probe" = the screen-probe stage; "cache" = the world SH cache only;
    # "ddgi" = probe volumes over the BVH
    gi_mode: str = "probe"
    probe_cfg: Optional[sp.ScreenProbeConfig] = None   # None = defaults
    gi_cfg: Optional[gi_ops.GIConfig] = None           # None = defaults
    ddgi_cfg: Optional[ddgi_ops.DDGIConfig] = None     # None = defaults
    # software-BVH rays for the probes and specular misses
    gi_rt: bool = False
    rt_rays: int = 4
    # the frame is declared dynamic: scrolled cascade strips assume static
    # casters between refreshes, so scroll is turned off
    rt_dynamic: bool = False
    rt_granularity: str = "meshlet"
    ssr: bool = False               # screen-space reflections (with gi)
    textured: bool = False
    normal_mapped: bool = False
    pbr_textures: bool = False
    trilinear: bool = False
    alpha_masked: bool = False
    # alpha-tested masked shadow casters (the reference's Masked depth
    # permutation); cascades >= shadow_masked_cascades draw masked casters
    # as opaque
    shadow_masked: bool = True
    shadow_masked_cascades: int = 2
    # cascade i's LOD threshold is lod_threshold_px * shadow_lod_scale *
    # shadow_lod_cascade_factor**i
    shadow_lod_cascade_factor: float = 2.0
    masked_draw_capacity: int = 1024
    masked_layers: int = 1         # 2 = depth-peel a second masked layer
    alpha_blend: bool = False
    blend_draw_capacity: int = 512
    # does any Blend-bucket material carry a base map? False skips the
    # blend pass's texture sample; set from the scene's material list
    blend_textured: bool = True
    motion_res_div: int = 2
    debug_mode: str = "none"


def check_slice(config: RendererConfig, mcfg: MeshletFrameConfig) -> None:
    """Every flag of chord_tpu's frame is ported: nothing is refused.
    ssr=True without gi is a no-op, as in chord_tpu, and so is gi_rt."""


def pixel_view_dirs(h: int, w: int, clip_to_tw: torch.Tensor) -> torch.Tensor:
    """Per-pixel view directions in translated world: unproject NDC
    (x, y, z=0.5) and normalize."""
    dev = clip_to_tw.device
    xs = centres(w, dev) * 2.0 - 1.0
    ys = 1.0 - centres(h, dev) * 2.0
    px = xs[None, :, None].expand(h, w, 1)
    py = ys[:, None, None].expand(h, w, 1)
    p = (px * clip_to_tw[0] + py * clip_to_tw[1] + 0.5 * clip_to_tw[2] +
         clip_to_tw[3])
    pw = torch.where(torch.abs(p[..., 3:4]) > 1e-9, p[..., 3:4],
                     torch.ones((), device=dev))
    d = p[..., :3] / pw
    # XLA rewrites (a / b) / c as a / (b * c)
    return p[..., :3] / (pw * torch.clamp_min(norm3(d, keepdim=True), 1e-8))


def render_shadow_cascade(pools, instances, view: DeviceView,
                          rc_main: RasterConfig, mcfg: MeshletFrameConfig,
                          k: int, mats=None, planes_all=None, prev_map=None,
                          prev_mat=None, prev_valid=None,
                          force_full: Optional[bool] = None,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """Depth-only raster of cascade `k` through the main view's rasterizer
    (reference renderShadow, renderer.cpp:350) -> (R,R) reverse-Z map.
    `mats`/`planes_all` override the view's host fit. `stats`, when given,
    receives the draws each cull dropped past its capacity
    (`shadow_draw_overflow`, `shadow_masked_overflow`, 0 without masked
    casters) and the pairs the bins dropped (`shadow_bin_overflow`).

    Scrolled cache (ShadowConfig.scroll): given the cascade's cached map
    and the matrix it was rendered with (`prev_map`, `prev_mat`,
    `prev_valid`), a new fit that differs from the cached one by a pure
    integer-texel light-space translation seeds the raster with the cached
    map shifted by it (exposed texels zeroed) and keeps only the work-queue
    tiles of the exposed edge strips. Any other change degrades to the
    full raster on the device (seed 0, every tile kept); `force_full` (the
    periodic full refresh) skips the plan."""
    scfg = mcfg.shadow_cfg
    mats = view.shadow_tw_to_light if mats is None else mats
    planes_all = (view.shadow_frustum_planes if planes_all is None
                  else planes_all)
    r = scfg.resolution
    # tile_h divides R and is a multiple of 8 and of sub_s, at most 128
    tile_h = next((t for t in range(min(128, r), 7, -8)
                   if r % t == 0 and t % rc_main.sub_s == 0), None)
    if tile_h is None:
        raise ValueError(
            f"no valid shadow tile_h for resolution {r} with "
            f"sub_s={rc_main.sub_s}: need a multiple of 8 and of sub_s "
            f"that divides {r}")
    rc = RasterConfig(width=r, height=r, tile_h=tile_h,
                      pair_capacity=rc_main.pair_capacity,
                      big_capacity=rc_main.big_capacity, sub_s=rc_main.sub_s)
    m, planes = mats[k], planes_all[k]
    masked = (mcfg.alpha_masked and mcfg.shadow_masked
              and k < mcfg.shadow_masked_cascades)
    lod_thr = (mcfg.lod_threshold_px * mcfg.shadow_lod_scale *
               mcfg.shadow_lod_cascade_factor ** k)
    proj_scale = 0.5 * r * m[1, 1]
    n_cap = -(-pools.num_pairs // 128) * 128

    def depth_pass(bucket, cap, rcfg, seed=None):
        res = cull_pairs(pools, instances, planes, proj_scale, cap,
                         lod_threshold=lod_thr, enable_cone=False,
                         masked=bucket)   # depth pass: no backface cull
        setup = mesh_shader_setup(res.draws, pools, instances, m, cap, r, r,
                                  backface_cull=False, sub_s=rc.sub_s)
        q = bin_windows(setup, rcfg, tile_keep=tile_keep)
        return res, q, raster_queue(q, setup, rcfg,
                                    seeds=None if seed is None else (seed,))

    seed = tile_keep = None
    if (scfg.scroll and prev_map is not None and prev_mat is not None
            and not force_full):
        seed, tile_keep = _scroll_plan(m, prev_map, prev_mat, prev_valid, rc)
    res, q, rts = depth_pass(False if masked else None,
                             min(mcfg.shadow_draw_capacity, n_cap), rc, seed)
    depth = rts[0]
    masked_overflow = torch.zeros((), dtype=torch.int32, device=depth.device)
    bin_overflow = q.overflow
    if masked:
        # alpha-tested masked casters: raster the masked bucket with uv
        # attributes, alpha-test it, keep the nearer depth
        res_m, q_m, rts = depth_pass(True,
                                     min(mcfg.masked_draw_capacity, n_cap),
                                     rc._replace(with_attrs=True))
        hit, keep = shading.masked_alpha_keep(
            rts[1], rts[5], rts[6], res_m.draws.object_id, 0, pools,
            instances)
        depth = torch.maximum(depth, torch.where(
            hit & keep, rts[0], torch.zeros((), device=depth.device)))
        masked_overflow = res_m.draws.overflow
        bin_overflow = bin_overflow + q_m.overflow
    if stats is not None:
        stats["shadow_draw_overflow"] = res.draws.overflow
        stats["shadow_masked_overflow"] = masked_overflow
        stats["shadow_bin_overflow"] = bin_overflow
    return depth


def _scroll_plan(m, prev_map, prev_mat, prev_valid, rc: RasterConfig):
    """-> (seed (R,R), tile_keep (n_tiles,)) of a scrolled refresh; both
    reduce to the full raster (zeros, all tiles) where the new fit is not
    an integer-texel translation of the cached one. The shift stays on the
    device: new[y,x] = old[y-dy, x-dx] is a gather."""
    r = rc.width
    pm = prev_mat
    dev = m.device
    # NDC -> texel: x_px = (x+1)R/2, y flipped
    dx_f = (m[3, 0] - pm[3, 0]) * (r * 0.5)
    dy_f = (pm[3, 1] - m[3, 1]) * (r * 0.5)
    dxi = torch.round(dx_f).to(torch.int32)
    dyi = torch.round(dy_f).to(torch.int32)
    same_basis = ((torch.abs(m[:3, :] - pm[:3, :]).amax() < 1e-6) &
                  (torch.abs(m[3, 2] - pm[3, 2]) < 1e-5))
    texel_exact = ((torch.abs(dx_f - dxi) < 2e-2) &
                   (torch.abs(dy_f - dyi) < 2e-2))
    can = same_basis & texel_exact & (torch.abs(dxi) < r) & \
        (torch.abs(dyi) < r)
    if prev_valid is not None:
        can = can & (prev_valid > 0)
    xs = torch.arange(r, dtype=torch.int32, device=dev)
    rolled = prev_map[torch.remainder(xs - dyi, r).long()][
        :, torch.remainder(xs - dxi, r).long()]
    exp_x = torch.where(dxi > 0, xs < dxi, xs >= r + dxi)
    exp_y = torch.where(dyi > 0, xs < dyi, xs >= r + dyi)
    exposed = exp_y[:, None] | exp_x[None, :]
    seed = torch.where(can & ~exposed, rolled,
                       torch.zeros((), device=dev))
    ceil_div = lambda a, b: -torch.div(-a, b, rounding_mode="floor")
    ncx = ceil_div(torch.abs(dxi), rc.tile_w)
    ncy = ceil_div(torch.abs(dyi), rc.tile_h)
    ti = torch.arange(rc.n_tiles, dtype=torch.int32, device=dev)
    tx, ty = ti % rc.tiles_x, ti // rc.tiles_x
    keep_c = torch.where(dxi > 0, tx < ncx, tx >= rc.tiles_x - ncx)
    keep_r = torch.where(dyi > 0, ty < ncy, ty >= rc.tiles_y - ncy)
    return seed, (keep_c | keep_r) | ~can


def _shadow_cascade_fit(view: DeviceView, history: FrameHistory,
                        scfg: ShadowConfig):
    """Cascade matrices and planes: the device fit to last frame's
    valid-depth range (quantized to sqrt(2) buckets under scroll, so the
    fit stays bit-stable between bucket edges), or to the static span;
    the view's host fit without camera geometry."""
    if not ((scfg.depth_range_fit or scfg.scroll)
            and view.view_forward is not None):
        return view.shadow_tw_to_light, view.shadow_frustum_planes
    full = const((0.0, 1e9), history.depth_range.device)
    raw = torch.where(history.valid > 0, history.depth_range, full)
    if scfg.scroll and scfg.depth_range_fit:
        qlo = torch.pow(2.0, torch.floor(
            torch.log2(torch.clamp_min(raw[0], 0.1)) * 2.0) * 0.5)
        qhi = torch.pow(2.0, torch.ceil(
            torch.log2(torch.clamp(raw[1], 1.0, 1e9)) * 2.0) * 0.5)
        zr = torch.stack([qlo, qhi])
    elif scfg.scroll:
        zr = full
    else:
        zr = raw
    return fit_cascades_device(view.view_forward, view.sun_direction,
                               view.tan_half_fov[0], view.tan_half_fov[1],
                               zr, scfg)


def _phase_expand(q, fc: int, ph: int, he: int, we: int):
    """A phase-decimated PCSS eval (he/ph, we/ph) -> eval res (he, we) at
    the phase of frame `fc`: nearest upsample + shift to the phase offset.
    -> (mask, phase_mask marking the pixels fresh this frame; None at
    ph=1)."""
    if ph <= 1:
        return q, None
    py_, px_ = divmod(fc % (ph * ph), ph)
    mask = torch.roll(post.upsample_nearest(q, ph, he, we), (py_, px_),
                      (0, 1))
    dev = q.device
    iy = torch.arange(he, device=dev)[:, None]
    ix = torch.arange(we, device=dev)[None, :]
    return mask, (iy % ph == py_) & (ix % ph == px_)


def _blend_shadow_mask(mask_q, phase_mask, pos_q, prev_mask, hist_valid,
                       valid_q, disocc_q, pm, a0: float):
    """Temporal soft-shadow blend (reference lighting.h:23-29): reproject
    last frame's eval-res mask through the previous view-projection; fresh
    phase pixels blend toward the new PCSS value, the rest keep the
    reprojected history unless the residual says the shadow moved."""
    hq, wq = mask_q.shape
    c = (pos_q[..., 0:1] * pm[0] + pos_q[..., 1:2] * pm[1] +
         pos_q[..., 2:3] * pm[2] + pm[3])
    wc = torch.clamp_min(c[..., 3], 1e-6)
    px = (c[..., 0] / wc * 0.5 + 0.5) * wq
    py = (0.5 - c[..., 1] / wc * 0.5) * hq
    on = (px >= 0) & (px < wq) & (py >= 0) & (py < hq) & (c[..., 3] > 0)
    xi = torch.clamp(f2i(px), 0, wq - 1).long()
    yi = torch.clamp(f2i(py), 0, hq - 1).long()
    prev = prev_mask[yi, xi]
    resid = torch.abs(prev - mask_q)
    if phase_mask is not None:
        base = torch.where(phase_mask, a0, 1.0)
    else:
        base = a0
    alpha = (base * hist_valid * on.float() * valid_q.float() *
             (1.0 - disocc_q) * torch.exp(-4.0 * resid))
    return mask_q + (prev - mask_q) * alpha


def _refresh_cascade(pools, instances, view, history, rc, mcfg, fc: int,
                     stats: Optional[dict]):
    """shadow.cascade_fit -> shadow.render: refresh cascade fc % N of the
    cached cascades (fit, scrolled raster with the periodic full refresh)
    -> (cascade maps, their matrices); the refresh's overflows go to
    `stats`."""
    scfg = mcfg.shadow_cfg
    n_casc, r = scfg.cascade_count, scfg.resolution
    if tuple(history.shadow_maps.shape) != (n_casc, r, r):
        raise ValueError(
            f"history.shadow_maps is {tuple(history.shadow_maps.shape)}, "
            f"the cascade cache needs {(n_casc, r, r)}: FrameHistory.empty("
            f"..., shadow_div=..., shadow_cascades={n_casc}, shadow_res={r})")
    if view.view_forward is None and view.shadow_tw_to_light is None:
        raise ValueError("shadows=True needs the view's cascade fit: "
                         "DeviceView.from_uniform(..., shadow_cfg=...)")
    k = fc % n_casc
    fit_mats, fit_planes = _shadow_cascade_fit(view, history, scfg)
    force_full = None
    if scfg.scroll_refresh_n:
        force_full = (fc // n_casc + k) % scfg.scroll_refresh_n == 0
    new_map = render_shadow_cascade(
        pools, instances, view, rc, mcfg, k, mats=fit_mats,
        planes_all=fit_planes, prev_map=history.shadow_maps[k],
        prev_mat=history.shadow_mats[k], prev_valid=history.valid,
        force_full=force_full, stats=stats)
    maps = history.shadow_maps.clone()
    maps[k] = new_map
    mats = history.shadow_mats.clone()
    mats[k] = fit_mats[k]
    return maps, mats


def _eval_inputs(gbuf, disocc, scfg: ShadowConfig, fc: int) -> dict:
    """The PCSS's inputs at eval res (1/eval_res_div): this frame's phase
    of the grid (pos_e, nrm_e; phase-amortized PCSS evaluates 1/ph^2 of it
    a frame, rotating) and the temporal blend's (pos_q, valid_q,
    disocc_q) -> chord_tpu's `shadow_split` dict, with the host's frame
    counter as `fc`."""
    kdiv = scfg.eval_res_div
    pos_q = post.decimate(gbuf.position_tw, kdiv)
    nrm_q = post.decimate(gbuf.normal, kdiv)
    ph = scfg.temporal_phase if scfg.temporal else 1
    if ph > 1:
        py_, px_ = divmod(fc % (ph * ph), ph)
        pos_e = post.decimate(torch.roll(pos_q, (-py_, -px_), (0, 1)), ph)
        nrm_e = post.decimate(torch.roll(nrm_q, (-py_, -px_), (0, 1)), ph)
    else:
        pos_e, nrm_e = pos_q, nrm_q
    return {"pos_e": pos_e, "nrm_e": nrm_e, "pos_q": pos_q,
            "valid_q": post.decimate(gbuf.valid, kdiv),
            "disocc_q": post.decimate(disocc, kdiv), "fc": fc}


def _evaluate_blend(sp: dict, view, history, maps, mats, scfg: ShadowConfig):
    """shadow.evaluate -> shadow.temporal: PCSS (K6) on the eval inputs
    `sp` against the cascades, expanded to eval res at the frame's phase
    and blended with the reprojected mask -> (PCSS q, mask)."""
    pos_e = sp["pos_e"]
    noise = None
    if scfg.jitter:
        noise = interleaved_gradient_noise(pos_e.shape[0], pos_e.shape[1],
                                           sp["fc"], device=pos_e.device)
    q = evaluate_shadow_auto(pos_e, sp["nrm_e"], view.sun_direction, maps,
                             mats, scfg, noise=noise)
    ph = scfg.temporal_phase if scfg.temporal else 1
    he, we = sp["pos_q"].shape[:2]
    mask, phase_mask = _phase_expand(q, sp["fc"], ph, he, we)
    if scfg.temporal:
        mask = _blend_shadow_mask(
            mask, phase_mask, sp["pos_q"], history.shadow_mask,
            history.valid, sp["valid_q"], sp["disocc_q"],
            view.prev_tw_to_clip_nj, scfg.temporal_alpha)
    return q, mask


def _upsample_shadow(mask, kdiv: int, h: int, w: int) -> torch.Tensor:
    """shadow.upsample: the eval-res mask at full res, 5-tap smoothed (it
    hides the upsample blocks)."""
    s = post.upsample_nearest(mask, kdiv, h, w)
    return (s + torch.roll(s, 1, 0) + torch.roll(s, -1, 0) +
            torch.roll(s, 1, 1) + torch.roll(s, -1, 1)) * 0.2


def _render_shadows(pools, instances, view, history, rc, mcfg, gbuf, disocc,
                    fc: int, h: int, w: int, stats: dict):
    """The inline shadow block (chord_tpu meshlet_frame.py:699-823):
    refresh cascade fc % N, evaluate PCSS on this frame's phase of the
    eval grid, blend the temporal mask, upsample -> (sun_shadow (H,W), new
    mask, new cascade maps, their matrices); the refresh's overflows go to
    `stats`."""
    scfg = mcfg.shadow_cfg
    maps, mats = _refresh_cascade(pools, instances, view, history, rc, mcfg,
                                  fc, stats)
    sp = _eval_inputs(gbuf, disocc, scfg, fc)
    _, mask = _evaluate_blend(sp, view, history, maps, mats, scfg)
    return (_upsample_shadow(mask, scfg.eval_res_div, h, w), mask, maps,
            mats)


def shadow_pipelined(scfg: ShadowConfig, device) -> bool:
    """Resolve ShadowConfig.pipelined (None = auto) as chord_tpu does
    (meshlet_frame.py:1189-1206), with `device` (the frame's tensors')
    in place of jax.default_backend(): auto splits only where the PCSS is
    told to skip its kernel (eval_kernel=False) off the CPU, which
    evaluate_shadow_auto refuses on the card; so auto is inline here and
    there, and pipelined=True runs the split on either device."""
    pipe = scfg.pipelined
    if pipe is None:
        on_card = torch.device(device).type != "cpu"
        ek = on_card if scfg.eval_kernel is None else scfg.eval_kernel
        pipe = (not ek) and on_card
    return bool(pipe)


def shadow_service_step(pools, instances, view: DeviceView,
                        history: FrameHistory, sp: dict, *,
                        config: RendererConfig, mcfg: "MeshletFrameConfig",
                        stats: Optional[dict] = None):
    """The split shadow dispatch (chord_tpu meshlet_frame.py:1299-1386),
    run after the frame that exported `sp` (its stats["shadow_split"]:
    pos_e, nrm_e, pos_q, valid_q, disocc_q and `fc`, the frame's host
    frame counter) on that frame's view and the history it returned:
    cascade fit (to that frame's depth range), the round-robin refresh of
    cascade fc % N with scroll and scroll_refresh_n (scroll off under
    rt_dynamic), PCSS (K6), the phase expand and the temporal blend. Its
    outputs re-enter the next frame through history.{shadow_maps,
    shadow_mats, shadow_mask}. `stats`, when given, receives the
    refresh's overflows (shadow_draw_overflow, shadow_masked_overflow,
    shadow_bin_overflow). -> (shadow_maps (N,R,R), shadow_mats (N,4,4),
    q (He/ph, We/ph), mask (He, We))."""
    if mcfg.rt_dynamic and mcfg.shadow_cfg.scroll:
        # dynamic casters invalidate scrolled strips
        mcfg = mcfg._replace(
            shadow_cfg=mcfg.shadow_cfg._replace(scroll=False))
    maps, mats = _refresh_cascade(pools, instances, view, history,
                                  config.raster_config(), mcfg, sp["fc"],
                                  stats)
    q, mask = _evaluate_blend(sp, view, history, maps, mats,
                              mcfg.shadow_cfg)
    return maps, mats, q, mask


def _atmosphere(view: DeviceView, h: int, w: int):
    """The atmosphere block (chord_tpu meshlet_frame.py:652-697): the view's
    LUTs (built inline when absent), sky radiance per pixel (LUT sampled
    at 1/4 res and bilinearly upsampled, sun disk at full res), the sky's
    ambient and the sun tinted by transmittance at the camera.
    -> (sky_radiance, sky along the view without the sun, ambient, sun
    radiance), AP1."""
    p_atm = atm.AtmosphereParams()
    t_lut, ms_lut = view.atmo_t_lut, view.atmo_ms_lut
    if t_lut is None:
        t_lut = atm.build_transmittance_lut(p_atm,
                                            device=view.sun_direction.device)
        ms_lut = atm.build_multiscatter_lut(p_atm, t_lut, dir_samples=16,
                                            steps=12)
    sky_lut = view.atmo_sky_lut
    if sky_lut is None:
        sky_lut = atm.build_sky_view_lut(p_atm, t_lut, ms_lut,
                                         view.sun_direction)
    dirs = pixel_view_dirs(h, w, view.clip_to_tw)
    sky_base = post.upsample_linear(
        atm.sample_sky(sky_lut, post.decimate(dirs, 4)), 4, h, w)
    sky_srgb = sky_base + atm.sun_disk_radiance(p_atm, t_lut, dirs,
                                                view.sun_direction)
    ambient = colorspace.srgb_to_acescg(
        atm.sky_ambient_irradiance(sky_lut))[None, None, :]
    t_sun = atm.sample_transmittance(
        t_lut, p_atm, const(p_atm.ground_radius_km + 0.2, t_lut.device),
        view.sun_direction[1])
    return (colorspace.srgb_to_acescg(sky_srgb),
            colorspace.srgb_to_acescg(sky_base), ambient,
            colorspace.srgb_to_acescg(t_sun * p_atm.sun_illuminance))


def _aerial(hdr, gbuf, sky_along_view, view: DeviceView):
    """Aerial perspective on geometry (reference lighting.hlsl:75-135; the
    closed-form slant path of ops/atmosphere.py)."""
    p_ap = atm.AtmosphereParams()
    dist = norm3(gbuf.position_tw)
    dir_y = gbuf.position_tw[..., 1] / torch.clamp_min(dist, 1e-6)
    alt_km = (view.cam_world_y * p_ap.km_per_unit
              if view.cam_world_y is not None else 0.2)
    t_ap, in_scatter = atm.aerial_perspective(
        p_ap, dist, sky_along_view, cam_alt_km=alt_km, view_dir_y=dir_y)
    return torch.where(gbuf.valid[..., None], hdr * t_ap + in_scatter, hdr)


class GIOut(NamedTuple):
    """What the GI block hands the rest of the frame."""

    ambient: torch.Tensor       # (H,W,3) AO'd ambient + indirect diffuse
    specular: torch.Tensor      # (H,W,3) specular GI, added after lighting
    indirect: torch.Tensor      # (H,W,3) indirect diffuse (the `gi` view)
    gi_cache: torch.Tensor      # the new history fields, named as in
    probe_sh: torch.Tensor      # FrameHistory
    probe_depth: torch.Tensor
    gi_diffuse: torch.Tensor
    gi_specular: torch.Tensor
    ddgi: ddgi_ops.DDGIState


def _probe_diffuse(view: DeviceView, history: FrameHistory, gbuf, depth,
                   motion_dilated, disocc, sky_amb, sun_radiance,
                   frame_index: int, mcfg: MeshletFrameConfig,
                   gcfg: gi_ops.GIConfig, bvh: Optional[rt.SceneBVH]):
    """The screen-probe stage (chord_tpu meshlet_frame.py:849-949) ->
    (indirect (H,W,3), new gi_cache, probe_sh, probe_depth, gi_diffuse).
    The samples are the neighbour taps, or the march's rays (trace_mode
    "march", each of weight 1); with gi_rt and a BVH, rt_rays rays a probe
    join them."""
    spcfg = mcfg.probe_cfg or sp.ScreenProbeConfig()
    with record_function("gi.probe.spawn"):
        probes = sp.spawn_probes(gbuf, depth, history.frame_count, spcfg)
    with record_function("gi.probe.sh_reproject"):
        sh_hist, n_hist = sp.reproject_probe_sh(
            probes, history.probe_sh, history.probe_depth,
            view.prev_tw_to_clip_nj, history.valid, spcfg)
    rt_parts = None
    if mcfg.gi_rt and bvh is not None:
        # rays that see geometry off the screen: the first rt_rays of the
        # frame's 4-ray (at least) set, from 0.05 above the probe
        k = mcfg.rt_rays
        with record_function("gi.probe.rt_trace"):
            rt_dirs = sp.probe_ray_dirs(probes, frame_index,
                                        spcfg._replace(rays=max(k, 4))
                                        )[..., :k, :]
            org = (probes.pos_tw[..., None, :] +
                   probes.normal[..., None, :] * 0.05).expand(rt_dirs.shape)
            t_rt, leaf_rt = rt.trace(org, rt_dirs, bvh)
            rt_rad, rt_conf = rt.shade_hits(t_rt, leaf_rt, org, rt_dirs, bvh,
                                            view.sun_direction, sun_radiance,
                                            sky_amb * 0.5)
            rt_parts = (rt_rad, rt_dirs, rt_conf)
    if spcfg.trace_mode == "taps":
        with record_function("gi.probe.taps"):
            # last frame's lit colour at (about) the probe pixels
            ph_n, pw_n = probes.depth.shape
            tc = history.tsr_color
            sy = max(tc.shape[0] // ph_n, 1)
            sx = max(tc.shape[1] // pw_n, 1)
            scene_rad = post.decimate(tc, (sy, sx))[:ph_n, :pw_n]
            rad, ray_dirs, sample_w = sp.gather_probe_taps(
                probes, scene_rad, sky_amb, spcfg)
    else:
        ray_dirs = sp.probe_ray_dirs(probes, frame_index, spcfg)
        with record_function("gi.probe.trace"):
            rad, ray_dirs = sp.trace_probes(
                probes, post.decimate(depth, spcfg.depth_div),
                history.tsr_color, view.tw_to_clip_nj, history.frame_count,
                spcfg, world_cache=history.gi_cache, gi_cfg=gcfg,
                sky_ambient=sky_amb, dirs=ray_dirs)
        sample_w = torch.ones(rad.shape[:-1], device=depth.device)
    if rt_parts is not None:
        rad, ray_dirs, sample_w = (torch.cat([a, b], dim=2) for a, b in
                                   zip((rad, ray_dirs, sample_w), rt_parts))
    with record_function("gi.probe.project_sh"):
        probe_sh = sp.project_and_merge(rad, ray_dirs, probes, sh_hist,
                                        n_hist, spcfg, weights=sample_w)
    with record_function("gi.probe.world_inject"):
        gi_cache = sp.inject_world_cache(history.gi_cache, probe_sh, probes,
                                         gcfg, frame_index=frame_index)
    depth_half = post.decimate(depth, 2)
    normal_half = post.decimate(gbuf.normal, 2)
    with record_function("gi.probe.interpolate"):
        diff_half = sp.interpolate_half(probe_sh, probes, normal_half,
                                        post.decimate(gbuf.valid, 2), spcfg)
    with record_function("gi.probe.history_reproject"):
        diff_half = sp.history_reproject_half(
            diff_half, post.decimate(motion_dilated, 2), history.gi_diffuse,
            history.valid, spcfg, disocclusion=post.decimate(disocc, 2))
    with record_function("gi.probe.spatial_filter"):
        diff_half = sp.spatial_filter_half(diff_half, depth_half,
                                           normal_half, spcfg)
    with record_function("gi.probe.upsample"):
        indirect = sp.bilateral_upsample(diff_half, depth_half, normal_half,
                                         depth, gbuf.normal)
        indirect = torch.where(gbuf.valid[..., None], indirect,
                               torch.zeros((), device=depth.device))
    return indirect, gi_cache, probe_sh, probes.depth, diff_half


def specular_directions(pos_q: torch.Tensor, nrm_q: torch.Tensor,
                        rough_q: torch.Tensor, frame_count):
    """The specular GI's directions (chord_tpu meshlet_frame.py:969-984)
    at the sample res: the GGX half-vector about the view direction
    -pos / |pos|, with the IGN pair of `frame_count` at each pixel, and the
    view reflected about it -> (h_ggx, refl_q), rounded as chord_tpu's
    jitted frame (the length and the dot summed (p0 + p1) + p2)."""
    v_q = -pos_q / torch.clamp_min(norm3(pos_q, keepdim=True), 1e-6)
    hq, wq = rough_q.shape
    u1 = interleaved_gradient_noise(hq, wq, frame_count)
    u2 = interleaved_gradient_noise(hq, wq, frame_count + 31)
    h_ggx = sp.ggx_sample_normal(nrm_q, v_q, rough_q, u1, u2)
    return h_ggx, 2.0 * dot3(v_q, h_ggx)[..., None] * h_ggx - v_q


def specular_nov(pos: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """The specular GI's N.V (chord_tpu meshlet_frame.py:1033-1036), its
    length and dot summed (p0 + p1) + p2."""
    return torch.clamp(dot3(-pos / torch.clamp_min(norm3(pos, keepdim=True),
                                                   1e-6), nrm), 1e-3, 1.0)


def _specular_gi(view: DeviceView, history: FrameHistory, gbuf, depth,
                 motion_dilated, disocc, ao, sun_radiance,
                 mcfg: MeshletFrameConfig, gcfg: gi_ops.GIConfig,
                 bvh: Optional[rt.SceneBVH]):
    """Specular GI (chord_tpu meshlet_frame.py:963-1044): a GGX-sampled
    reflection direction per 1/sample_res_div pixel, the world cache's
    radiance along it, SSR hits over it (and, with gi_rt and a BVH, BVH
    hits where SSR missed), the filter chain -> (specular (H,W,3) times the
    analytic split-sum env term and AO, new gi_specular)."""
    dev = depth.device
    with record_function("gi.specular"):
        k = gcfg.sample_res_div
        pos_q = post.decimate(gbuf.position_tw, k)
        nrm_q = post.decimate(gbuf.normal, k)
        rough_q = post.decimate(gbuf.roughness, k)
        h_ggx, refl_q = specular_directions(pos_q, nrm_q, rough_q,
                                            history.frame_count)
        anchor = torch.zeros(3, device=dev)
        spec_q, conf_q = gi_ops.sample_radiance(history.gi_cache, pos_q,
                                                refl_q, anchor, gcfg)
        spec_q = spec_q * conf_q[..., None]
        if mcfg.ssr:
            # h_ggx as the march's virtual normal: SSR follows the same
            # GGX-sampled direction; its hits override the cache
            ssr_col, ssr_conf = ssr_ops.trace(
                post.decimate(depth, k), history.tsr_color, pos_q, h_ggx,
                view.tw_to_clip_nj, ssr_ops.SSRConfig(res_div=k))
            ssr_conf = ssr_conf * history.valid
            spec_q = (spec_q * (1 - ssr_conf[..., None]) +
                      ssr_col * ssr_conf[..., None])
            if mcfg.gi_rt and bvh is not None:
                # SSR's misses fall back to BVH hits before the cache
                with record_function("gi.specular.rt"):
                    t_rt, leaf_rt = rt.trace(pos_q + nrm_q * 0.05, refl_q,
                                             bvh)
                    rt_col, rt_conf = rt.shade_hits(
                        t_rt, leaf_rt, pos_q, refl_q, bvh,
                        view.sun_direction, sun_radiance,
                        view.sky_ambient * 0.5)
                    take = ((1.0 - ssr_conf) * rt_conf)[..., None]
                    spec_q = spec_q * (1 - take) + rt_col * take
    with record_function("gi.specular.filter"):
        spec_q = sp.specular_firefly_clamp(spec_q, pos_q, nrm_q, rough_q)
        spec_q = sp.spatial_filter_specular(spec_q, pos_q, nrm_q, rough_q)
        spec_q = sp.temporal_specular(
            spec_q, post.decimate(motion_dilated, k), history.gi_specular,
            history.valid, rough_q, disocclusion=post.decimate(disocc, k))
    hh, ww = gbuf.valid.shape
    spec = post.upsample_nearest(spec_q, k, hh, ww)
    nov = specular_nov(gbuf.position_tw, gbuf.normal)
    f0 = (0.04 * (1.0 - gbuf.metallic[..., None]) +
          gbuf.base_color * gbuf.metallic[..., None])
    env = brdf.env_specular_analytic(f0, gbuf.roughness, nov)
    return spec * env * ao[..., None], spec_q


def _render_gi(view: DeviceView, history: FrameHistory, gbuf, depth,
               motion_dilated, disocc, ambient, sun_radiance,
               frame_index: int, mcfg: MeshletFrameConfig, h: int, w: int,
               bvh: Optional[rt.SceneBVH]) -> GIOut:
    """The GI block (chord_tpu meshlet_frame.py:825-1046): AO (RTAO with
    ao_mode "rtao" and a BVH, else SSAO), the diffuse indirect (probe,
    ddgi or cache mode) and the specular GI; `ambient` is the
    atmosphere's (None without); `bvh` the scene BVH the gi_rt rays, RTAO
    and DDGI trace (None: no rays, as in chord_tpu)."""
    gcfg = mcfg.gi_cfg or gi_ops.GIConfig()
    dev = depth.device
    with record_function("gi.ao"):
        kd = gcfg.ao_res_div
        pos_a = post.decimate(gbuf.position_tw, kd)
        nrm_a = post.decimate(gbuf.normal, kd)
        if gcfg.ao_mode == "rtao" and bvh is not None:
            ao_h = gi_ops.rtao(pos_a, nrm_a, bvh, gcfg,
                               frame_index=history.frame_count)
        else:
            ao_h = gi_ops.ssao(post.decimate(depth, kd), pos_a, nrm_a, gcfg)
        ao = post.upsample_nearest(ao_h, kd, h, w)
    sky_amb = (ambient.reshape(3) if ambient is not None
               else view.sky_ambient)
    # the fields a mode does not write carry over; cache and ddgi modes
    # inject the world cache after lighting (the frame calls update_cache)
    gi_cache, probe_sh, probe_depth, gi_diffuse, ddgi = (
        history.gi_cache, history.probe_sh, history.probe_depth,
        history.gi_diffuse, history.ddgi)
    if mcfg.gi_mode == "probe":
        indirect, gi_cache, probe_sh, probe_depth, gi_diffuse = \
            _probe_diffuse(view, history, gbuf, depth, motion_dilated,
                           disocc, sky_amb, sun_radiance, frame_index, mcfg,
                           gcfg, bvh)
    elif mcfg.gi_mode == "ddgi":
        dcfg = mcfg.ddgi_cfg or ddgi_ops.DDGIConfig()
        with record_function("gi.ddgi.update"):
            ddgi = ddgi_ops.ddgi_update(
                history.ddgi, bvh, view.sun_direction, sun_radiance, sky_amb,
                history.frame_count, dcfg, frame_index=frame_index)
        with record_function("gi.ddgi.sample"):
            indirect = ddgi_ops.diffuse_ddgi(ddgi, gbuf, dcfg)
    else:
        with record_function("gi.sample"):
            indirect = gi_ops.diffuse_gi(history.gi_cache, gbuf,
                                         torch.zeros(3, device=dev), gcfg)
    specular, gi_specular = _specular_gi(view, history, gbuf, depth,
                                         motion_dilated, disocc, ao,
                                         sun_radiance, mcfg, gcfg, bvh)
    if ambient is None:
        ambient = view.sky_ambient[None, None, :] * torch.clamp(
            gbuf.normal[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    return GIOut(ambient=(ambient * 0.35 + indirect) * ao[..., None],
                 specular=specular, indirect=indirect, gi_cache=gi_cache,
                 probe_sh=probe_sh, probe_depth=probe_depth,
                 gi_diffuse=gi_diffuse, gi_specular=gi_specular, ddgi=ddgi)


# lod level -> colour (chord_tpu meshlet_frame.py:412-415)
_LOD_PALETTE = ((1.0, 1.0, 1.0), (0.0, 1.0, 0.0), (1.0, 1.0, 0.0),
                (1.0, 0.5, 0.0), (1.0, 0.0, 0.0), (1.0, 0.0, 1.0),
                (0.0, 0.0, 1.0), (0.0, 1.0, 1.0))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its int32 wrap-around, still int64 (two's complement)."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def debug_visualize(mode: str, hdr, vis, depth, gbuf, draw_meshlet, pools,
                    extras=None) -> torch.Tensor:
    """The debug views (chord_tpu meshlet_frame.py:388-422; reference
    nanite_visualize.cpp): `meshlet` hashes each pixel's meshlet id to a
    colour, `lod` colours its LOD level, `normal` and `depth` show the
    gbuffer; a mode in `extras` shows that plane (clamped to [0,1], a 2-D
    plane as grey); any other mode returns `hdr`."""
    extras = extras or {}
    if mode in extras:
        v = extras[mode]
        if v.dim() == 2:
            v = v[..., None].expand(*v.shape, 3)
        return torch.clamp(v, 0.0, 1.0)
    slot, _tri = unpack_visibility(vis)
    valid = (slot >= 0)[..., None]
    zero = torch.zeros((), device=depth.device)
    if mode in ("meshlet", "lod"):
        mid = draw_meshlet.long()[torch.clamp_min(slot, 0).long()]
    if mode == "meshlet":
        # chord_tpu's int32 hash: products wrap, the shift is arithmetic
        h1 = (_wrap_i32(mid * 40503) ^ (_wrap_i32(mid * 1231) >> 3)) & 0xFFFF
        # a divide by a device constant: CUDA's `t / 255.0` multiplies by
        # the reciprocal
        k = const(255.0, depth.device)
        col = torch.stack([(h1 * 7) % 255 / k, (h1 * 13) % 255 / k,
                           (h1 * 29) % 255 / k], -1)
        return torch.where(valid, col, zero)
    if mode == "lod":
        lvl = pools.meshlet_lod.long()[mid]
        col = const(_LOD_PALETTE, depth.device)[torch.clamp(lvl, 0, 7)]
        return torch.where(valid, col, zero)
    if mode == "normal":
        return torch.where(valid, gbuf.normal * 0.5 + 0.5, zero)
    if mode == "depth":
        d = torch.clamp(depth * 50.0, 0.0, 1.0)[..., None]
        return d.expand(*d.shape[:2], 3)
    return hdr


def render_frame_meshlet(pools, instances, view: DeviceView,
                         history: FrameHistory, config: RendererConfig,
                         mcfg: MeshletFrameConfig,
                         frame_index: Optional[int] = None,
                         bvh: Optional[rt.SceneBVH] = None, group=None
                         ) -> Tuple[torch.Tensor, FrameHistory, dict]:
    """One GPU-driven frame -> (image (Hp,Wp,3) u8, new history, stats).
    `frame_index` is the host's copy of history.frame_count; the shadow
    pass and GI need it. `bvh` (ops/rt.SceneBVH) is what the gi_rt rays,
    RTAO and DDGI trace; without it the rays are skipped and RTAO falls
    back to SSAO, as in chord_tpu; DDGI needs it (AssertionError, as
    chord_tpu's assert). `group` (a torch.distributed process group;
    None = one device): the ranks that each render one strip; the
    exposure histogram is their mean (chord_tpu's `axis_name`)."""
    check_slice(config, mcfg)
    if (mcfg.shadows or mcfg.gi) and frame_index is None:
        raise ValueError("shadows=True or gi=True needs frame_index, the "
                         "host's copy of history.frame_count")
    if mcfg.gi and mcfg.gi_mode == "ddgi" and bvh is None:
        raise AssertionError("gi_mode='ddgi' needs the scene BVH (enable "
                             "gi_rt)")
    if mcfg.rt_dynamic and mcfg.shadow_cfg.scroll:
        mcfg = mcfg._replace(
            shadow_cfg=mcfg.shadow_cfg._replace(scroll=False))
    rc = config.raster_config()
    rc_a = rc._replace(with_attrs=True)
    cap = min(mcfg.draw_capacity, -(-pools.num_pairs // 128) * 128)
    h, w = config.height, config.width
    proj_scale = 0.5 * h * view.tw_to_clip_nj[1, 1]
    ws, hs, offs = hzb_layout(w, h)
    stats = {}
    # phase-1 capacity; also the masked bucket's payload base is cap + cap1
    # (the draw_object concat below), so 0 without occlusion
    cap1 = max(256, -(-cap // 4 // 128) * 128) if mcfg.occlusion else 0

    active = None
    if mcfg.object_precull:
        # cull.object_precull: the active table holds every frustum-visible
        # pair, sized by the scene's visible set (not the draw capacity)
        acap = mcfg.active_pair_capacity or min(pools.num_pairs,
                                                max(16384, 4 * cap))
        active = build_active_pairs(pools, instances, view.frustum_planes,
                                    acap)
        stats["active_pairs"] = active.count
        stats["active_overflow"] = active.overflow

    count_i = lambda s: s.valid.to(torch.int32).sum().to(torch.int32)
    # with a masked bucket the opaque phases are opaque-only
    opq = False if mcfg.alpha_masked else None
    if mcfg.occlusion:
        # cull.phase0 vs last frame's HZB (invalid history -> all zeros ->
        # all pass), raster.phase0
        prev_hzb = HZBPyramid(flat=history.hzb_flat, widths=ws, heights=hs,
                              offsets=offs, mip0_w=w, mip0_h=h)
        res0 = cull_pairs(pools, instances, view.frustum_planes, proj_scale,
                          cap, hzb=prev_hzb,
                          hzb_tw_to_clip=view.prev_tw_to_clip_nj,
                          lod_threshold=mcfg.lod_threshold_px, masked=opq,
                          active=active)
        setup0 = mesh_shader_setup(res0.draws, pools, instances,
                                   view.tw_to_clip, cap, w, h,
                                   sub_s=rc_a.sub_s)
        queue0 = bin_windows(setup0, rc_a)
        rt0 = raster_queue(queue0, setup0, rc_a)
        # hzb.mid -> cull.phase1 (the occluded remainder) -> raster.phase1
        hzb_now = build_hzb(rt0[0])
        res1 = cull_pairs(pools, instances, view.frustum_planes, proj_scale,
                          cap1, hzb=hzb_now,
                          hzb_tw_to_clip=view.tw_to_clip_nj,
                          lod_threshold=mcfg.lod_threshold_px,
                          extra_mask=res0.occluded_mask, masked=opq,
                          active=active)
        setup1 = mesh_shader_setup(res1.draws, pools, instances,
                                   view.tw_to_clip, cap1, w, h,
                                   payload_base=cap, sub_s=rc_a.sub_s)
        queue1 = bin_windows(setup1, rc_a)
        rt = raster_queue(queue1, setup1, rc_a, seeds=rt0)
        draw_object = torch.cat([res0.draws.object_id,
                                 res1.draws.object_id])
        draw_meshlet = torch.cat([res0.draws.meshlet_id,
                                  res1.draws.meshlet_id])
        stats["drawn_tris"] = count_i(setup0) + count_i(setup1)
        stats["bin_overflow"] = queue0.overflow + queue1.overflow
        stats["draws_phase0"] = res0.draws.count
        stats["draws_phase1"] = res1.draws.count
        stats["draw_overflow"] = res0.draws.overflow + res1.draws.overflow
    else:
        # one cull with no HZB, one raster
        res0 = cull_pairs(pools, instances, view.frustum_planes, proj_scale,
                          cap, lod_threshold=mcfg.lod_threshold_px,
                          masked=opq, active=active)
        setup0 = mesh_shader_setup(res0.draws, pools, instances,
                                   view.tw_to_clip, cap, w, h,
                                   sub_s=rc_a.sub_s)
        queue0 = bin_windows(setup0, rc_a)
        rt = raster_queue(queue0, setup0, rc_a)
        draw_object = res0.draws.object_id
        draw_meshlet = res0.draws.meshlet_id
        stats["drawn_tris"] = count_i(setup0)
        stats["bin_overflow"] = queue0.overflow
        stats["draws_phase0"] = res0.draws.count
        stats["draw_overflow"] = res0.draws.overflow

    depth, vis = rt[0], rt[1]
    # next frame's phase-0 occluders: opaque only (a masked surface full
    # of holes must not occlude)
    hzb_final = build_hzb(depth)
    new_depth_range = history.depth_range
    if view.z_near is not None:
        # the occupied depth range feeds next frame's cascade fit
        new_depth_range = valid_depth_range(depth, view.z_near)

    if mcfg.alpha_masked:
        # the masked bucket (reference pipeline_filter + Masked raster
        # permutation): cull vs the fresh opaque HZB, raster into its own
        # layer, then punch through with the deferred alpha test
        cap_m = min(mcfg.masked_draw_capacity,
                    -(-pools.num_pairs // 128) * 128)
        base_m = cap + cap1
        res_m = cull_pairs(pools, instances, view.frustum_planes, proj_scale,
                           cap_m, hzb=hzb_final,
                           hzb_tw_to_clip=view.tw_to_clip_nj,
                           lod_threshold=mcfg.lod_threshold_px, masked=True,
                           active=active)
        setup_m = mesh_shader_setup(res_m.draws, pools, instances,
                                    view.tw_to_clip, cap_m, w, h,
                                    payload_base=base_m, sub_s=rc_a.sub_s)
        q_m = bin_windows(setup_m, rc_a)
        rt_m = raster_queue(q_m, setup_m, rc_a)
        depth_opaque = depth
        accept = shading.alpha_mask_accept(
            rt_m[1], rt_m[0], depth, rt_m[5], rt_m[6], res_m.draws.object_id,
            base_m, pools, instances)
        rt = [torch.where(accept, m_, o_) for m_, o_ in zip(rt_m, rt)]
        depth, vis = rt[0], rt[1]
        if mcfg.masked_layers >= 2:
            # masked.peel: re-raster the same masked queue behind layer 0's
            # depth (z-clip), so each pixel gets its next-nearest masked
            # fragment; it takes the pixel only where layer 0 failed its
            # alpha test
            rt_p = raster_queue(q_m, setup_m, rc_a._replace(z_clip=True),
                                zclip=rt_m[0])
            accept_p = shading.alpha_mask_accept(
                rt_p[1], rt_p[0], depth_opaque, rt_p[5], rt_p[6],
                res_m.draws.object_id, base_m, pools, instances) & ~accept
            rt = [torch.where(accept_p, p_, o_) for p_, o_ in zip(rt_p, rt)]
            depth, vis = rt[0], rt[1]
        draw_object = torch.cat([draw_object, res_m.draws.object_id])
        draw_meshlet = torch.cat([draw_meshlet, res_m.draws.meshlet_id])
        stats["draws_masked"] = res_m.draws.count
        stats["draw_overflow"] = stats["draw_overflow"] + res_m.draws.overflow

    gbuf = shading.resolve_gbuffer_raster_rt(
        vis, depth, rt[2], rt[3], rt[4], rt[5], rt[6], draw_object, pools,
        instances, view.clip_to_tw, view.tw_to_clip_nj,
        view.prev_tw_to_clip_nj, textured=mcfg.textured,
        normal_mapped=mcfg.normal_mapped, pbr_textures=mcfg.pbr_textures,
        mip_dither_frame=(history.frame_count
                          if mcfg.trilinear and mcfg.textured else None),
        motion_div=mcfg.motion_res_div)

    # tsr.prepare + the quarter-res disocclusion mask
    motion_dilated = post.tsr_prepare(gbuf.motion, depth)
    dq = post.disocclusion_mask(
        post.decimate(gbuf.position_tw, 4), post.decimate(gbuf.valid, 4),
        post.decimate(history.depth, 4), view.prev_tw_to_clip_nj,
        history.valid)
    disocc = post.upsample_nearest(dq, 4, h, w)

    sky_radiance = sky_along_view = ambient = None
    sun_radiance = view.sun_radiance
    if mcfg.atmosphere:
        sky_radiance, sky_along_view, ambient, sun_radiance = _atmosphere(
            view, h, w)

    sun_shadow = None
    new_shadow = (history.shadow_mask, history.shadow_maps,
                  history.shadow_mats)
    if mcfg.shadows and shadow_pipelined(mcfg.shadow_cfg, depth.device):
        # the split: export the PCSS's and the blend's inputs for
        # shadow_service_step and light with the mask it made last frame;
        # no cascade raster, PCSS or blend in the frame
        stats["shadow_split"] = _eval_inputs(gbuf, disocc, mcfg.shadow_cfg,
                                             frame_index)
        sun_shadow = _upsample_shadow(history.shadow_mask,
                                      mcfg.shadow_cfg.eval_res_div, h, w)
    elif mcfg.shadows:
        sun_shadow, *new_shadow = _render_shadows(
            pools, instances, view, history, rc, mcfg, gbuf, disocc,
            frame_index, h, w, stats)

    gi = None
    if mcfg.gi:
        gi = _render_gi(view, history, gbuf, depth, motion_dilated, disocc,
                        ambient, sun_radiance, frame_index, mcfg, h, w, bvh)
        ambient = gi.ambient

    sun = shading.SunLight(direction=view.sun_direction,
                           radiance=sun_radiance,
                           sky_ambient=view.sky_ambient)
    hdr = shading.shade_pixels(gbuf, sun, sun_shadow=sun_shadow,
                               ambient=ambient, sky_radiance=sky_radiance)
    if gi is not None:
        hdr = hdr + torch.where(gbuf.valid[..., None], gi.specular,
                                torch.zeros((), device=hdr.device))

    if mcfg.alpha_blend:
        # one depth-peeled translucent layer, forward-shaded and
        # composited over the lit scene
        cap_b = min(mcfg.blend_draw_capacity,
                    -(-pools.num_pairs // 128) * 128)
        res_b = cull_pairs(pools, instances, view.frustum_planes, proj_scale,
                           cap_b, hzb=hzb_final,
                           hzb_tw_to_clip=view.tw_to_clip_nj,
                           lod_threshold=mcfg.lod_threshold_px,
                           masked="blend", active=active)
        setup_b = mesh_shader_setup(res_b.draws, pools, instances,
                                    view.tw_to_clip, cap_b, w, h,
                                    sub_s=rc_a.sub_s)
        rt_b = raster_queue(bin_windows(setup_b, rc_a), setup_b, rc_a)
        b_col, b_alpha = shading.shade_blend_layer(
            rt_b[1], rt_b[0], depth, rt_b[2], rt_b[3], rt_b[4], rt_b[5],
            rt_b[6], res_b.draws.object_id, pools, instances, sun,
            sun_shadow=sun_shadow, ambient=ambient,
            textured=mcfg.blend_textured and mcfg.textured)
        hdr = hdr * (1.0 - b_alpha[..., None]) + b_col * b_alpha[..., None]
        stats["draws_blend"] = res_b.draws.count

    if mcfg.atmosphere:
        hdr = _aerial(hdr, gbuf, sky_along_view, view)

    if gi is not None and mcfg.gi_mode != "probe":
        # cache mode: inject this frame's lit surfels (probe mode injected
        # the screen probes above)
        with record_function("gi.inject"):
            gi = gi._replace(gi_cache=gi_ops.update_cache(
                history.gi_cache, gbuf, hdr,
                torch.zeros(3, device=hdr.device),
                mcfg.gi_cfg or gi_ops.GIConfig(),
                frame_count=history.frame_count, frame_index=frame_index))

    ecfg = post.ExposureConfig(fix_exposure=float(cvars.get("r.exposure.fix")))
    hist_lum = post.luminance_histogram(hdr, ecfg)
    if group is not None:
        hist_lum = all_reduce_mean(hist_lum, group)
    exposure = post.adapt_exposure(hist_lum, history.exposure, 1.0 / 60.0,
                                   ecfg)

    if mcfg.debug_mode != "none":
        extras = {"disocclusion": disocc,
                  "motion": torch.cat([torch.abs(motion_dilated) * 20.0,
                                       torch.zeros_like(depth)[..., None]],
                                      -1)}
        if gi is not None:
            extras["gi"] = gi.indirect * 2.0
            extras["specular"] = gi.specular * 4.0
        if sun_shadow is not None:
            extras["shadow"] = sun_shadow      # the PCSS sun visibility
        hdr = debug_visualize(mcfg.debug_mode, hdr, vis, depth, gbuf,
                              draw_meshlet, pools, extras=extras)

    post_w = config.post_width or w
    post_h = config.post_height or h
    if config.enable_tsr:
        tsr_cfg = post.TSRConfig(mode=config.tsr_mode)
        if (post_w, post_h) != (w, h):
            hdr = post.temporal_upscale(
                hdr, motion_dilated, history.tsr_color, history.valid,
                view.jitter_px, tsr_cfg, post_h, post_w,
                disocclusion=disocc)
        else:
            hdr = post.temporal_resolve(hdr, motion_dilated,
                                        history.tsr_color, history.valid,
                                        tsr_cfg, disocclusion=disocc)
    elif (post_w, post_h) != (w, h):
        hdr = post.upsample_nearest(hdr, (-(-post_h // h), -(-post_w // w)),
                                    post_h, post_w)
    tsr_color = hdr
    if config.enable_bloom:
        hdr = hdr + post.compute_bloom(hdr, post.BloomConfig())
    image = colorspace.to_u8(colorspace.tonemap_display(hdr, exposure,
                                                        config.output))
    new_history = FrameHistory(
        valid=torch.ones((), dtype=torch.float32, device=depth.device),
        frame_count=history.frame_count + 1,
        hzb_flat=hzb_final.flat,
        depth=depth,
        exposure=exposure,
        tsr_color=tsr_color,
        depth_range=new_depth_range,
        shadow_mask=new_shadow[0],
        shadow_maps=new_shadow[1],
        shadow_mats=new_shadow[2],
        # GIOut names the GI fields as the history does
        **{f: getattr(history if gi is None else gi, f)
           for f in GIOut._fields[3:]})
    return image, new_history, stats


SEQUENCE_STATS = ("drawn_tris", "bin_overflow", "draw_overflow",
                  "active_overflow", "draws_phase0", "draws_phase1",
                  "draws_masked", "shadow_draw_overflow",
                  "shadow_masked_overflow", "shadow_bin_overflow")


def resolve_split(stats: dict, pools, instances, view: DeviceView,
                  history: FrameHistory, config: RendererConfig,
                  mcfg: MeshletFrameConfig) -> FrameHistory:
    """After a frame: when it exported a shadow split (pipelined shadows),
    run shadow_service_step on it (its overflows into `stats`) and fold
    the cascades, matrices and mask into the history the next frame reads
    (chord_tpu's MeshletRenderer._resolve_split); else `history` as is."""
    sp = stats.get("shadow_split")
    if sp is None:
        return history
    maps, mats, _, mask = shadow_service_step(
        pools, instances, view, history, sp, config=config, mcfg=mcfg,
        stats=stats)
    return history.replace(shadow_maps=maps, shadow_mats=mats,
                           shadow_mask=mask)


def _run_sequence(pools, instances, views_stacked, history, config, mcfg,
                  bvh, with_stats):
    """The host loop of both sequence runners: each frame, then its shadow
    service when it exported a split. With shadows or GI the frame
    counter is read once, before the loop, and counted on the host;
    nothing inside the loop reads the device."""
    images, per_frame = [], []
    fc0 = int(history.frame_count) if mcfg.shadows or mcfg.gi else None
    for i in range(views_stacked.num_frames):
        view = views_stacked.frame(i)
        image, history, stats = render_frame_meshlet(
            pools, instances, view, history, config, mcfg,
            frame_index=None if fc0 is None else fc0 + i, bvh=bvh)
        history = resolve_split(stats, pools, instances, view, history,
                                config, mcfg)
        images.append(image)
        per_frame.append({k: stats[k] for k in SEQUENCE_STATS if k in stats})
    images = torch.stack(images)
    if not with_stats:
        return images, history
    return images, history, {k: torch.stack([s[k] for s in per_frame])
                             for k in per_frame[0]}


def render_sequence_meshlet(pools, instances, views_stacked: DeviceView,
                            history: FrameHistory, config: RendererConfig,
                            mcfg: MeshletFrameConfig,
                            bvh: Optional[rt.SceneBVH] = None,
                            with_stats: bool = False):
    """Render a camera path (DeviceView stacked along a leading (N,) axis)
    frame by frame -> (images (N,Hp,Wp,3) u8, history[, stats]) where stats
    maps each per-frame stat to an (N,) tensor (worst-frame audits read
    its max: in-sequence overflow is invisible to a single fresh frame).
    `bvh` goes to every frame. A pipelined-shadow config is refused, as
    chord_tpu refuses it (its service step is a dispatch of its own):
    render_sequence_split runs it."""
    if mcfg.shadows and shadow_pipelined(mcfg.shadow_cfg,
                                         history.frame_count.device):
        raise ValueError(
            "render_sequence_meshlet cannot run a pipelined-shadow frame "
            "(the split eval is its own dispatch): use "
            "render_sequence_split")
    return _run_sequence(pools, instances, views_stacked, history, config,
                         mcfg, bvh, with_stats)


def render_sequence_split(pools, instances, views_stacked: DeviceView,
                          history: FrameHistory, config: RendererConfig,
                          mcfg: MeshletFrameConfig,
                          bvh: Optional[rt.SceneBVH] = None,
                          with_stats: bool = False):
    """The camera-path runner for pipelined-shadow configs (chord_tpu
    meshlet_frame.py:1419-1442): a host loop of the frame, then the
    shadow service on the split it exported, whose cascades, matrices
    and mask the next frame reads -> render_sequence_meshlet's outputs,
    the service's shadow overflows among the stats. Any other config
    renders as render_sequence_meshlet would."""
    return _run_sequence(pools, instances, views_stacked, history, config,
                         mcfg, bvh, with_stats)


class MeshletRenderer:
    """Host-side runner for the meshlet frame (chord_tpu MeshletRenderer),
    for every config (the repo's golden images render through it); with
    pipelined shadows it runs the shadow service after each frame, the
    cascade warm-up frames included. History and
    views go to the device the pools live on; the atmosphere LUTs and,
    with GI, the env-BRDF LUT are built once (the sky view once per sun
    direction); with gi_rt or DDGI the scene BVH is built on the host at
    mcfg.rt_granularity from the render's instances at the first render,
    and at every render under rt_dynamic."""

    def __init__(self, config: RendererConfig,
                 mcfg: MeshletFrameConfig = MeshletFrameConfig()):
        check_slice(config, mcfg)
        self.config = config
        self.mcfg = mcfg
        self.history: Optional[FrameHistory] = None
        self._atmo_cache = None
        self._sky_cache = (None, None)
        self._brdf_cache = None
        self._bvh: Optional[rt.SceneBVH] = None

    def reset_history(self) -> None:
        self.history = None

    def _atmo_luts(self, sun_direction, device):
        """-> (transmittance, multiscatter, sky view) LUTs on `device`."""
        p_atm = atm.AtmosphereParams()
        if self._atmo_cache is None:
            t = atm.build_transmittance_lut(p_atm, 40, device=device)
            self._atmo_cache = (t, atm.build_multiscatter_lut(
                p_atm, t, dir_samples=16, steps=12))
        t, ms = self._atmo_cache
        key = tuple(np.round(np.asarray(sun_direction), 5).tolist())
        if self._sky_cache[0] != key:
            d = np.asarray(sun_direction, np.float32)
            d = torch.from_numpy(d / np.linalg.norm(d)).to(device)
            self._sky_cache = (key, atm.build_sky_view_lut(p_atm, t, ms, d))
        return t, ms, self._sky_cache[1]

    def _brdf_lut(self, device):
        if self._brdf_cache is None:
            self._brdf_cache = brdf.build_env_brdf_lut(64, device=device)
        return self._brdf_cache

    def _frame(self, pools, instances, view, frame_index):
        image, self.history, stats = render_frame_meshlet(
            pools, instances, view, self.history, self.config, self.mcfg,
            frame_index=frame_index, bvh=self._bvh)
        self.history = resolve_split(stats, pools, instances, view,
                                     self.history, self.config, self.mcfg)
        return image, stats

    def render(self, pools, instances, view_uniform, **light_kwargs):
        """-> (image, stats) for one frame; history carries over. The first
        frame after a reset first fills every cached cascade (one frame per
        cascade but the last), as after a camera cut."""
        c, m = self.config, self.mcfg
        dev = pools.positions.device
        fresh = self.history is None
        if fresh:
            scfg = m.shadow_cfg
            probe = m.gi and m.gi_mode == "probe"
            self.history = FrameHistory.empty(
                c.height, c.width, post_h=c.post_height or None,
                post_w=c.post_width or None,
                gi_cfg=(m.gi_cfg or gi_ops.GIConfig()) if m.gi else None,
                shadow_div=scfg.eval_res_div,
                shadow_cascades=scfg.cascade_count if m.shadows else 0,
                shadow_res=scfg.resolution if m.shadows else 1,
                shadow_phase=scfg.temporal_phase if scfg.temporal else 1,
                probe_tile=((m.probe_cfg.tile if m.probe_cfg else 8)
                            if probe else 0),
                ddgi_cfg=((m.ddgi_cfg or ddgi_ops.DDGIConfig())
                          if m.gi and m.gi_mode == "ddgi" else None),
                device=dev)
        view = DeviceView.from_uniform(
            view_uniform, device=dev,
            shadow_cfg=m.shadow_cfg if m.shadows else None, **light_kwargs)
        if m.atmosphere:
            t, ms, sky = self._atmo_luts(
                light_kwargs.get("sun_direction", (0.3, 0.8, 0.5)), dev)
            view = view.replace(atmo_t_lut=t, atmo_ms_lut=ms,
                                atmo_sky_lut=sky)
        if m.gi:
            view = view.replace(brdf_lut=self._brdf_lut(dev))
        if m.gi and (m.gi_rt or m.gi_mode == "ddgi") and \
                (self._bvh is None or m.rt_dynamic):
            # rt_dynamic rebuilds it every render, so the rays follow
            # moving instances
            self._bvh = rt.build_scene_bvh(pools, instances,
                                           granularity=m.rt_granularity)
        fc = (int(self.history.frame_count) if m.shadows or m.gi
              else None)
        if fresh and m.shadows:
            for _ in range(m.shadow_cfg.cascade_count - 1):
                self._frame(pools, instances, view, fc)
                fc += 1
        return self._frame(pools, instances, view, fc)
