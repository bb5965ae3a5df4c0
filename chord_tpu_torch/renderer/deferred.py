"""The flat deferred frame, its host-side runner, the per-frame device
view and the static renderer configuration (port of
chord_tpu/renderer/deferred.py: DeviceView, RendererConfig,
render_frame_flat and DeferredRenderer; reference PerframeCameraView,
shader/base.h:292, and DeferredRenderer::render, renderer.cpp:142-499).

The flat frame (BASELINE config #1, Sponza-class): object frustum cull ->
vertex transform -> visibility raster of every triangle of the visible
objects (`rasterize`: K1, K7 with the r.raster.bricks cvar, or K8 with
RendererConfig.subtiles) -> g-buffer resolve from the flat pools ->
lighting -> auto exposure -> gather-mode TSR at render size -> bloom ->
tonemap.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import colorspace, post, shading
from ..ops.raster import RasterConfig, rasterize
from ..ops.transform import frustum_cull_spheres, transform_to_clip
from ..rhi.framebuffer import FrameHistory
from ..utils.camera import ViewUniform
from ..utils.collectives import all_reduce_mean
from ..utils.cvar import cvars
from ..utils.device import resolve

# the renderer's own variables (chord_tpu deferred.py:42-50): the same
# names, defaults and types
cvars.register("r.exposure.fix", -1.0,
               "fixed exposure; <=0 enables auto exposure")
cvars.register("r.render.width", 1920, "render width", vtype=int)
cvars.register("r.render.height", 1080, "render height", vtype=int)
cvars.register("r.render.pairCapacity", 8192,
               "raster work-queue capacity", vtype=int)
cvars.register("r.render.drawCapacity", 4096,
               "visible meshlet draw capacity", vtype=int)
cvars.register("r.render.output", "srgb8", "srgb8 | hdr10", vtype=str)


# the atmosphere LUTs and the env-BRDF LUT: one set for a whole camera
# path, never stacked (each is 3-d; stacked it would be 4-d)
SHARED_FIELDS = ("atmo_t_lut", "atmo_ms_lut", "atmo_sky_lut", "brdf_lut")


@dataclass
class DeviceView:
    """Device-side per-frame camera view (f32 tensors, camera at the
    translated-world origin). The optional fields are None unless their
    feature is on."""

    tw_to_clip: torch.Tensor          # (4,4) jittered
    tw_to_clip_nj: torch.Tensor       # (4,4) no jitter
    prev_tw_to_clip_nj: torch.Tensor  # (4,4)
    frustum_planes: torch.Tensor      # (6,4)
    sun_direction: torch.Tensor       # (3,)
    sun_radiance: torch.Tensor        # (3,) AP1
    sky_ambient: torch.Tensor         # (3,) AP1
    dt: torch.Tensor                  # () seconds
    jitter_px: torch.Tensor           # (2,) subpixel jitter
    clip_to_tw: torch.Tensor          # (4,4) inverse no-jitter view-proj
    # atmosphere LUTs, built once by the host-side runner (the frame
    # builds them inline when absent): sun-independent transmittance and
    # multiple scattering, and the sky view of a static sun
    atmo_t_lut: Optional[torch.Tensor] = None    # (64,256,3)
    atmo_ms_lut: Optional[torch.Tensor] = None   # (32,32,3)
    atmo_sky_lut: Optional[torch.Tensor] = None  # (104,200,3)
    # split-sum env BRDF LUT (ops/brdf_lut.py), built once with GI on
    brdf_lut: Optional[torch.Tensor] = None      # (32,32,2)
    # shadow cascades (from_uniform(shadow_cfg=...)): the host
    # frustum-only fit, the fallback of the device depth-range fit
    shadow_tw_to_light: Optional[torch.Tensor] = None     # (N,4,4)
    shadow_frustum_planes: Optional[torch.Tensor] = None  # (N,6,4)
    shadow_splits: Optional[torch.Tensor] = None          # (N+1,)
    # camera geometry for the device cascade fit
    view_forward: Optional[torch.Tensor] = None           # (3,)
    tan_half_fov: Optional[torch.Tensor] = None           # (2,) tan_x, tan_y
    z_near: Optional[torch.Tensor] = None                 # ()
    # camera world altitude (f32 of the f64 host position), for the
    # altitude-aware aerial perspective
    cam_world_y: Optional[torch.Tensor] = None            # ()

    @classmethod
    def from_uniform(cls, u: ViewUniform, sun_direction=(0.3, 0.8, 0.5),
                     sun_radiance=(8.0, 7.6, 7.0),
                     sky_ambient=(0.3, 0.4, 0.6), dt: float = 1.0 / 60.0,
                     shadow_cfg=None, device=None) -> "DeviceView":
        """Host view uniform -> tensors on `device` (None = the card).
        `shadow_cfg` adds the host cascade fit and the camera geometry the
        device fit reads (chord_tpu deferred.py:105-146)."""
        device = resolve(device)
        d = np.asarray(sun_direction, np.float32)
        d = d / np.linalg.norm(d)
        sun_ap1 = np.asarray(sun_radiance, np.float32) @ colorspace.SRGB_TO_AP1
        sky_ap1 = np.asarray(sky_ambient, np.float32) @ colorspace.SRGB_TO_AP1
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device)
        shadow = {}
        if shadow_cfg is not None:
            from ..ops.shadow import fit_cascades
            from ..utils import math as cmath

            # view forward = -(third column of the view rotation)
            fwd = -u.translated_world_to_view.astype(np.float64)[:3, 2]
            aspect = u.render_size[0] / u.render_size[1]
            mats, splits = fit_cascades(fwd, d.astype(np.float64), u.fovy,
                                        aspect, shadow_cfg)
            planes = np.stack([cmath.frustum_planes(m.astype(np.float64))
                               for m in mats])
            tan_y = np.tan(u.fovy * 0.5)
            shadow = dict(shadow_tw_to_light=t(mats),
                          shadow_frustum_planes=t(planes),
                          shadow_splits=t(splits), view_forward=t(fwd),
                          tan_half_fov=t([tan_y * aspect, tan_y]),
                          z_near=t(u.z_near))
        return cls(
            tw_to_clip=t(u.translated_world_to_clip),
            tw_to_clip_nj=t(u.translated_world_to_clip_nojitter),
            prev_tw_to_clip_nj=t(u.prev_translated_world_to_clip_nojitter),
            frustum_planes=t(u.frustum_planes),
            sun_direction=t(d), sun_radiance=t(sun_ap1),
            sky_ambient=t(sky_ap1), dt=t(dt), jitter_px=t(u.jitter),
            clip_to_tw=t(np.float32(np.linalg.inv(
                u.translated_world_to_clip_nojitter.astype(np.float64)))),
            cam_world_y=t(u.camera_world_pos[1]), **shadow)

    def replace(self, **changes) -> "DeviceView":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def stack(views: List["DeviceView"]) -> "DeviceView":
        """Stack per-frame views along a leading (N,) axis. None fields stay
        None; a LUT that every view shares (the same tensor) is kept once."""
        out = {}
        for f in dataclasses.fields(DeviceView):
            vals = [getattr(v, f.name) for v in views]
            if vals[0] is None:
                out[f.name] = None
            elif f.name in SHARED_FIELDS and all(x is vals[0] for x in vals):
                out[f.name] = vals[0]
            else:
                out[f.name] = torch.stack(vals)
        return DeviceView(**out)

    def frame(self, i: int) -> "DeviceView":
        """Frame i of a stacked view (a shared LUT passes through)."""
        def pick(name, x):
            if x is None or (name in SHARED_FIELDS and x.dim() == 3):
                return x
            return x[i]
        return DeviceView(**{f.name: pick(f.name, getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    @property
    def num_frames(self) -> int:
        return self.dt.shape[0]


class RendererConfig(NamedTuple):
    """Static frame-shape configuration (chord_tpu RendererConfig fields,
    without the Pallas `interpret` switch)."""

    width: int = 1920
    height: int = 1080
    post_width: int = 0          # 0 = same as render (TSR upscale target)
    post_height: int = 0
    pair_capacity: int = 8192
    big_capacity: int = 128
    enable_bloom: bool = True
    enable_tsr: bool = True
    tsr_mode: str = "gather"
    subtiles: bool = False
    output: str = "srgb8"

    def raster_config(self) -> RasterConfig:
        """The raster config from the r.raster.* cvars. tile_h rounds down
        to a multiple of 8, of sub_s and, with bricks, of 4*sub_s (the
        bench cvars give 216, or 192 with bricks)."""
        bricks = bool(cvars.get("r.raster.bricks"))
        tile_h = int(cvars.get("r.raster.tileH"))
        sub_s = int(cvars.get("r.raster.subS"))
        mult = math.lcm(8, sub_s, 4 * sub_s if bricks else 1)
        if tile_h % mult != 0:
            tile_h = max(mult, tile_h // mult * mult)
        return RasterConfig(
            width=self.width, height=self.height, tile_h=tile_h,
            sub_s=sub_s,
            pair_capacity=self.pair_capacity,
            big_capacity=self.big_capacity, subtiles=self.subtiles,
            bricks=bricks, rp=int(cvars.get("r.raster.rp")))

    @classmethod
    def from_cvars(cls, **overrides) -> "RendererConfig":
        """The config the r.render.*, r.bloom.enable and r.tsr.enable
        cvars give (chord_tpu deferred.py:190-204); `overrides` win."""
        base = dict(
            width=int(cvars.get("r.render.width")),
            height=int(cvars.get("r.render.height")),
            pair_capacity=int(cvars.get("r.render.pairCapacity")),
            enable_bloom=bool(cvars.get("r.bloom.enable")),
            enable_tsr=bool(cvars.get("r.tsr.enable")),
            output=str(cvars.get("r.render.output")),
        )
        base.update(overrides)
        return cls(**base)


def render_frame_flat(pools, instances, view: DeviceView,
                      history: FrameHistory, config: RendererConfig,
                      group=None):
    """One flat frame -> (image (H,W,3) u8, new history, stats) (chord_tpu
    deferred.py:207-295). The TSR is always gather mode at render size
    (post.TSRConfig()), whatever config.tsr_mode says, as in chord_tpu;
    post_width/post_height are not read. Stats: bin_overflow, drawn_tris,
    binned_pairs, visible_objects. `group` (a torch.distributed process
    group; None = one device) is the set of ranks that each render one
    strip of the image: the exposure adapts to the whole image's
    histogram, their mean (chord_tpu's `axis_name` psum)."""
    rc = config.raster_config()
    obj_visible = (frustum_cull_spheres(instances.object_sphere_tw,
                                        view.frustum_planes)
                   & instances.object_valid)
    clip = transform_to_clip(pools.positions, pools.vertex_object,
                             instances.object_to_tw, view.tw_to_clip)
    tri_valid = pools.tri_valid & obj_visible[pools.tri_object.long()]
    n_tris = pools.indices.shape[0]
    payload = torch.arange(1, n_tris + 1, dtype=torch.int32,
                           device=clip.device)
    depth, vis, raster_stats = rasterize(clip, pools.indices, tri_valid,
                                         payload, rc)
    gbuf = shading.resolve_gbuffer(vis, pools, instances, view.tw_to_clip_nj,
                                   view.prev_tw_to_clip_nj)
    sun = shading.SunLight(direction=view.sun_direction,
                           radiance=view.sun_radiance,
                           sky_ambient=view.sky_ambient)
    hdr = shading.shade_pixels(gbuf, sun)
    ecfg = post.ExposureConfig(fix_exposure=float(cvars.get("r.exposure.fix")))
    hist_lum = post.luminance_histogram(hdr, ecfg)
    if group is not None:
        hist_lum = all_reduce_mean(hist_lum, group)
    exposure = post.adapt_exposure(hist_lum, history.exposure, 1.0 / 60.0,
                                   ecfg)
    if config.enable_tsr:
        hdr = post.temporal_resolve(hdr, gbuf.motion, history.tsr_color,
                                    history.valid, post.TSRConfig())
    tsr_color = hdr
    if config.enable_bloom:
        hdr = hdr + post.compute_bloom(hdr, post.BloomConfig())
    image = colorspace.to_u8(colorspace.tonemap_display(hdr, exposure,
                                                        config.output))
    new_history = dataclasses.replace(
        history, valid=torch.ones((), device=depth.device),
        frame_count=history.frame_count + 1, depth=depth, exposure=exposure,
        tsr_color=tsr_color)
    stats = dict(raster_stats)
    stats["visible_objects"] = obj_visible.to(torch.int32).sum().to(
        torch.int32)
    return image, new_history, stats


class DeferredRenderer:
    """Host-side runner of the flat frame: owns the history and turns each
    view uniform into a DeviceView on the pools' device (chord_tpu
    deferred.py:298-326)."""

    def __init__(self, config: RendererConfig):
        self.config = config
        self.history: Optional[FrameHistory] = None

    def reset_history(self) -> None:
        """Camera cut (reference clearHistory, renderer.cpp:95-105)."""
        self.history = None

    def render(self, pools, instances, view_uniform: ViewUniform,
               **light_kwargs):
        """-> (image (H,W,3) u8, stats) for one frame."""
        c = self.config
        dev = pools.positions.device
        if self.history is None:
            self.history = FrameHistory.empty(c.height, c.width, device=dev)
        view = DeviceView.from_uniform(view_uniform, device=dev,
                                       **light_kwargs)
        image, self.history, stats = render_frame_flat(
            pools, instances, view, self.history, c)
        return image, stats
