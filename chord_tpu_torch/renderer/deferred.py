"""Per-frame device view and static renderer configuration (port of
chord_tpu/renderer/deferred.py: DeviceView and RendererConfig; reference
PerframeCameraView, shader/base.h:292 and renderer.cpp:175-211)."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import colorspace
from ..ops.raster import RasterConfig
from ..utils.camera import ViewUniform
from ..utils.cvar import cvars
from ..utils.device import resolve


# the atmosphere LUTs: one set for a whole camera path, never stacked
SHARED_FIELDS = ("atmo_t_lut", "atmo_ms_lut", "atmo_sky_lut")


@dataclass
class DeviceView:
    """Device-side per-frame camera view (f32 tensors, camera at the
    translated-world origin). The optional fields are None unless their
    feature is on; chord_tpu's BRDF LUT joins with the GI slice."""

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
        if bool(cvars.get("r.raster.bricks")):
            raise NotImplementedError("r.raster.bricks: the brick-layout "
                                      "raster is not ported")
        tile_h = int(cvars.get("r.raster.tileH"))
        sub_s = int(cvars.get("r.raster.subS"))
        mult = math.lcm(8, sub_s)
        if tile_h % mult != 0:
            tile_h = max(mult, tile_h // mult * mult)
        return RasterConfig(
            width=self.width, height=self.height, tile_h=tile_h,
            sub_s=sub_s,
            pair_capacity=self.pair_capacity,
            big_capacity=self.big_capacity, subtiles=self.subtiles,
            rp=int(cvars.get("r.raster.rp")))
