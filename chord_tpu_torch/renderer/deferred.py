"""Per-frame device view and static renderer configuration (port of
chord_tpu/renderer/deferred.py: DeviceView and RendererConfig; reference
PerframeCameraView, shader/base.h:292 and renderer.cpp:175-211)."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from ..ops import colorspace
from ..ops.raster import RasterConfig
from ..utils.camera import ViewUniform
from ..utils.cvar import cvars


@dataclass
class DeviceView:
    """Device-side per-frame camera view (f32 tensors, camera at the
    translated-world origin). chord_tpu's view also carries atmosphere,
    BRDF and shadow-cascade inputs; those fields join with their slices."""

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

    @classmethod
    def from_uniform(cls, u: ViewUniform, sun_direction=(0.3, 0.8, 0.5),
                     sun_radiance=(8.0, 7.6, 7.0),
                     sky_ambient=(0.3, 0.4, 0.6), dt: float = 1.0 / 60.0,
                     shadow_cfg=None, device="cpu") -> "DeviceView":
        if shadow_cfg is not None:
            raise NotImplementedError(
                "DeviceView.from_uniform(shadow_cfg=...): shadow cascades "
                "belong to the shadows slice")
        d = np.asarray(sun_direction, np.float32)
        d = d / np.linalg.norm(d)
        sun_ap1 = np.asarray(sun_radiance, np.float32) @ colorspace.SRGB_TO_AP1
        sky_ap1 = np.asarray(sky_ambient, np.float32) @ colorspace.SRGB_TO_AP1
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device)
        return cls(
            tw_to_clip=t(u.translated_world_to_clip),
            tw_to_clip_nj=t(u.translated_world_to_clip_nojitter),
            prev_tw_to_clip_nj=t(u.prev_translated_world_to_clip_nojitter),
            frustum_planes=t(u.frustum_planes),
            sun_direction=t(d), sun_radiance=t(sun_ap1),
            sky_ambient=t(sky_ap1), dt=t(dt), jitter_px=t(u.jitter),
            clip_to_tw=t(np.float32(np.linalg.inv(
                u.translated_world_to_clip_nojitter.astype(np.float64)))))

    @staticmethod
    def stack(views: List["DeviceView"]) -> "DeviceView":
        """Stack per-frame views along a leading (N,) axis."""
        return DeviceView(**{f.name: torch.stack(
            [getattr(v, f.name) for v in views]) for f in
            dataclasses.fields(DeviceView)})

    def frame(self, i: int) -> "DeviceView":
        """Frame i of a stacked view."""
        return DeviceView(**{f.name: getattr(self, f.name)[i] for f in
                             dataclasses.fields(self)})

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
