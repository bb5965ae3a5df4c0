"""The GPU-driven meshlet frame (port of chord_tpu/renderer/meshlet_frame.py,
the `off` feature set: geometry + post).

Pass order (chord_tpu meshlet_frame.py:470-1166; reference
renderer.cpp:316-343 and mesh_raster.cpp:269-330):
cull.object_precull -> cull.phase0 (vs last frame's HZB) -> raster.phase0
-> hzb.mid -> cull.phase1 (the occluded remainder vs the fresh HZB) ->
raster.phase1 (seeded with phase 0) -> hzb.final -> gbuffer_resolve ->
tsr.prepare + disocclusion_mask -> lighting -> auto_exposure -> tsr
(render -> post upscale, tile reprojection) -> bloom -> tonemap.

Every flag outside that slice raises NotImplementedError naming the flag.
A frame is plain eager PyTorch around the four kernels (K1 raster, K2 mesh
shader, K3 row gather, K4 tile reproject) and needs no host sync: counts
and overflows stay on the device until the caller reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import colorspace, post, shading
from ..ops.cull import build_active_pairs, cull_pairs
from ..ops.hzb import HZBPyramid, build_hzb, hzb_layout
from ..ops.mesh_shader import mesh_shader_setup
from ..ops.raster import bin_windows, raster_queue
from ..rhi.framebuffer import FrameHistory
from ..utils.cvar import cvars
from .deferred import DeviceView, RendererConfig


class MeshletFrameConfig(NamedTuple):
    """chord_tpu MeshletFrameConfig's fields. The port runs the `off` set:
    occlusion + object_precull on, every optional feature off."""

    draw_capacity: int = 4096
    occlusion: bool = True
    lod_threshold_px: float = 1.0
    object_precull: bool = True
    active_pair_capacity: int = 0   # 0 = auto (min(P, max(16384, 4*cap)))
    shadows: bool = False
    atmosphere: bool = False
    gi: bool = False
    gi_rt: bool = False
    ssr: bool = False
    textured: bool = False
    normal_mapped: bool = False
    pbr_textures: bool = False
    trilinear: bool = False
    alpha_masked: bool = False
    alpha_blend: bool = False
    motion_res_div: int = 2
    debug_mode: str = "none"


_OFF_FLAGS = ("shadows", "atmosphere", "gi", "gi_rt", "ssr", "textured",
              "normal_mapped", "pbr_textures", "trilinear", "alpha_masked",
              "alpha_blend")


def check_slice(config: RendererConfig, mcfg: MeshletFrameConfig) -> None:
    """Raise NotImplementedError for any flag outside the ported slice."""
    for name in _OFF_FLAGS:
        if getattr(mcfg, name):
            raise NotImplementedError(
                f"MeshletFrameConfig.{name}=True is not ported yet")
    if mcfg.debug_mode != "none":
        raise NotImplementedError(
            f"MeshletFrameConfig.debug_mode={mcfg.debug_mode!r} is not "
            "ported yet")
    if not mcfg.occlusion:
        raise NotImplementedError(
            "MeshletFrameConfig.occlusion=False is not ported yet")
    if not mcfg.object_precull:
        raise NotImplementedError(
            "MeshletFrameConfig.object_precull=False is not ported yet")
    if not config.enable_tsr:
        raise NotImplementedError(
            "RendererConfig.enable_tsr=False is not ported yet")
    if config.tsr_mode != "tile":
        raise NotImplementedError(
            f"RendererConfig.tsr_mode={config.tsr_mode!r}: only 'tile' is "
            "ported")
    if (config.post_width or config.width,
            config.post_height or config.height) == (config.width,
                                                     config.height):
        raise NotImplementedError(
            "RendererConfig.post_width/post_height equal to the render "
            "size (TSR without upscale) is not ported yet")
    if config.subtiles:
        raise NotImplementedError("RendererConfig.subtiles=True is not "
                                  "ported")
    if config.output != "srgb8":
        raise NotImplementedError(
            f"RendererConfig.output={config.output!r} is not ported yet")


def render_frame_meshlet(pools, instances, view: DeviceView,
                         history: FrameHistory, config: RendererConfig,
                         mcfg: MeshletFrameConfig
                         ) -> Tuple[torch.Tensor, FrameHistory, dict]:
    """One GPU-driven frame -> (image (Hp,Wp,3) u8, new history, stats)."""
    check_slice(config, mcfg)
    rc = config.raster_config()
    rc_a = rc._replace(with_attrs=True)
    cap = min(mcfg.draw_capacity, -(-pools.num_pairs // 128) * 128)
    h, w = config.height, config.width
    proj_scale = 0.5 * h * view.tw_to_clip_nj[1, 1]
    ws, hs, offs = hzb_layout(w, h)
    stats = {}
    # phase-1 capacity; also the phase-1 payload base offset
    cap1 = max(256, -(-cap // 4 // 128) * 128)

    # cull.object_precull: the active table holds every frustum-visible
    # pair, sized by the scene's visible set (not the draw capacity)
    acap = mcfg.active_pair_capacity or min(pools.num_pairs,
                                            max(16384, 4 * cap))
    active = build_active_pairs(pools, instances, view.frustum_planes, acap)
    stats["active_pairs"] = active.count
    stats["active_overflow"] = active.overflow

    # cull.phase0 vs last frame's HZB (invalid history -> all zeros -> all
    # pass), raster.phase0
    prev_hzb = HZBPyramid(flat=history.hzb_flat, widths=ws, heights=hs,
                          offsets=offs, mip0_w=w, mip0_h=h)
    res0 = cull_pairs(pools, instances, view.frustum_planes, proj_scale, cap,
                      hzb=prev_hzb, hzb_tw_to_clip=view.prev_tw_to_clip_nj,
                      lod_threshold=mcfg.lod_threshold_px, active=active)
    setup0 = mesh_shader_setup(res0.draws, pools, instances, view.tw_to_clip,
                               cap, w, h, sub_s=rc_a.sub_s)
    queue0 = bin_windows(setup0, rc_a)
    rt0 = raster_queue(queue0, setup0, rc_a)
    # hzb.mid -> cull.phase1 (the occluded remainder) -> raster.phase1
    hzb_now = build_hzb(rt0[0])
    res1 = cull_pairs(pools, instances, view.frustum_planes, proj_scale, cap1,
                      hzb=hzb_now, hzb_tw_to_clip=view.tw_to_clip_nj,
                      lod_threshold=mcfg.lod_threshold_px,
                      extra_mask=res0.occluded_mask, active=active)
    setup1 = mesh_shader_setup(res1.draws, pools, instances, view.tw_to_clip,
                               cap1, w, h, payload_base=cap,
                               sub_s=rc_a.sub_s)
    queue1 = bin_windows(setup1, rc_a)
    rt = raster_queue(queue1, setup1, rc_a, seeds=rt0)
    draw_object = torch.cat([res0.draws.object_id, res1.draws.object_id])
    count_i = lambda s: s.valid.to(torch.int32).sum().to(torch.int32)
    stats["drawn_tris"] = count_i(setup0) + count_i(setup1)
    stats["bin_overflow"] = queue0.overflow + queue1.overflow
    stats["draws_phase0"] = res0.draws.count
    stats["draws_phase1"] = res1.draws.count
    stats["draw_overflow"] = res0.draws.overflow + res1.draws.overflow

    depth, vis = rt[0], rt[1]
    hzb_final = build_hzb(depth)     # next frame's phase-0 occluders

    gbuf = shading.resolve_gbuffer_raster_rt(
        vis, depth, rt[2], rt[3], rt[4], rt[5], rt[6], draw_object, pools,
        instances, view.clip_to_tw, view.tw_to_clip_nj,
        view.prev_tw_to_clip_nj, motion_div=mcfg.motion_res_div)

    # tsr.prepare + the quarter-res disocclusion mask
    motion_dilated = post.tsr_prepare(gbuf.motion, depth)
    dq = post.disocclusion_mask(
        post.decimate(gbuf.position_tw, 4), post.decimate(gbuf.valid, 4),
        post.decimate(history.depth, 4), view.prev_tw_to_clip_nj,
        history.valid)
    disocc = post.upsample_nearest(dq, 4, h, w)

    sun = shading.SunLight(direction=view.sun_direction,
                           radiance=view.sun_radiance,
                           sky_ambient=view.sky_ambient)
    hdr = shading.shade_pixels(gbuf, sun)

    ecfg = post.ExposureConfig(fix_exposure=float(cvars.get("r.exposure.fix")))
    exposure = post.adapt_exposure(post.luminance_histogram(hdr, ecfg),
                                   history.exposure, 1.0 / 60.0, ecfg)

    post_w = config.post_width or w
    post_h = config.post_height or h
    hdr = post.temporal_upscale(
        hdr, motion_dilated, history.tsr_color, history.valid,
        view.jitter_px, post.TSRConfig(mode=config.tsr_mode), post_h, post_w,
        disocclusion=disocc)
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
        depth_range=history.depth_range)
    return image, new_history, stats


SEQUENCE_STATS = ("drawn_tris", "bin_overflow", "draw_overflow",
                  "active_overflow", "draws_phase0", "draws_phase1")


def render_sequence_meshlet(pools, instances, views_stacked: DeviceView,
                            history: FrameHistory, config: RendererConfig,
                            mcfg: MeshletFrameConfig,
                            with_stats: bool = False):
    """Render a camera path (DeviceView stacked along a leading (N,) axis)
    frame by frame -> (images (N,Hp,Wp,3) u8, history[, stats]) where stats
    maps each per-frame stat to an (N,) tensor (worst-frame audits read
    its max: in-sequence overflow is invisible to a single fresh frame)."""
    images, per_frame = [], []
    for i in range(views_stacked.num_frames):
        image, history, stats = render_frame_meshlet(
            pools, instances, views_stacked.frame(i), history, config, mcfg)
        images.append(image)
        per_frame.append(stats)
    images = torch.stack(images)
    if not with_stats:
        return images, history
    seq = {k: torch.stack([s[k] for s in per_frame])
           for k in SEQUENCE_STATS}
    return images, history, seq


class MeshletRenderer:
    """Host-side runner for the meshlet frame (chord_tpu MeshletRenderer without
    the shadow / atmosphere / GI branches)."""

    def __init__(self, config: RendererConfig,
                 mcfg: MeshletFrameConfig = MeshletFrameConfig()):
        check_slice(config, mcfg)
        self.config = config
        self.mcfg = mcfg
        self.history: Optional[FrameHistory] = None

    def reset_history(self) -> None:
        self.history = None

    def render(self, pools, instances, view_uniform, **light_kwargs):
        """-> (image, stats) for one frame; history carries over."""
        c = self.config
        dev = pools.positions.device
        if self.history is None:
            self.history = FrameHistory.empty(
                c.height, c.width, post_h=c.post_height or None,
                post_w=c.post_width or None, device=dev)
        view = DeviceView.from_uniform(view_uniform, device=dev,
                                       **light_kwargs)
        image, self.history, stats = render_frame_meshlet(
            pools, instances, view, self.history, c, self.mcfg)
        return image, stats
