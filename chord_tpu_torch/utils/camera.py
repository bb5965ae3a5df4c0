"""Camera with large-world double-precision position.

Host-side port of chord_tpu/utils/camera.py, the reference ICamera (reference: utils/camera.h:24
— `math::dvec3 m_position` double position at :100, zNear 0.001 at :107,
frustum extraction, fills the PerframeCameraView GPU struct,
utils/camera.cpp:17).

Design: the camera position is float64 on the host; everything the device
sees is float32 in **translated world** space (world translated so the camera
sits at the origin), exactly the reference's precision trick
(shader/base.h:292-341 translatedWorldToClip etc.). Object transforms are
rebased per frame on the host: localToTranslatedWorld = localToWorld with the
f64 camera position subtracted from the translation row *before* the f32
cast, so fp32 never sees large magnitudes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import math as cmath


@dataclass
class ViewUniform:
    """Per-frame camera view data shipped to the device — the analog of the
    reference's PerframeCameraView (shader/base.h:292). All f32, camera at
    origin of translated world."""

    translated_world_to_view: np.ndarray   # (4,4) f32
    view_to_clip: np.ndarray               # (4,4) f32 (jittered)
    translated_world_to_clip: np.ndarray   # (4,4) f32 (jittered)
    translated_world_to_clip_nojitter: np.ndarray  # (4,4) f32
    prev_translated_world_to_clip_nojitter: np.ndarray  # (4,4) f32, prev frame
    frustum_planes: np.ndarray             # (6,4) f32 in translated world
    camera_world_pos: np.ndarray           # (3,) f64 — host only
    render_size: tuple                     # (w, h) pixels
    z_near: float
    fovy: float
    jitter: np.ndarray                     # (2,) f32 pixels
    frame_index: int = 0


@dataclass
class Camera:
    """Perspective fly camera (reference: ICamera + flower ViewportCamera)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float64))
    yaw: float = -90.0          # degrees, -90 looks down -Z
    pitch: float = 0.0          # degrees
    fovy_deg: float = 60.0
    z_near: float = 0.001       # reference: utils/camera.h:107
    width: int = 1920
    height: int = 1080
    _prev_vp_nj: np.ndarray | None = None

    @property
    def forward(self) -> np.ndarray:
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = np.cos(np.radians(self.pitch)), np.sin(np.radians(self.pitch))
        return cmath.normalize(np.array([cy * cp, sp, sy * cp]))

    def look_at(self, target: np.ndarray) -> None:
        d = cmath.normalize(np.asarray(target, np.float64) - self.position)
        self.pitch = float(np.degrees(np.arcsin(np.clip(d[1], -1, 1))))
        self.yaw = float(np.degrees(np.arctan2(d[2], d[0])))

    def view_uniform(self, frame_index: int = 0, jitter: bool = False,
                     phase_count: int = 8) -> ViewUniform:
        aspect = self.width / self.height
        fovy = np.radians(self.fovy_deg)

        # Translated world: camera at origin.
        view = cmath.look_at(np.zeros(3), self.forward, np.array([0.0, 1.0, 0.0]))
        proj_nj = cmath.perspective_reverse_z(fovy, aspect, self.z_near)

        if jitter:
            jxy = cmath.halton23_jitter(frame_index, phase_count)
        else:
            jxy = np.zeros(2)
        proj = proj_nj.copy()
        # Sub-pixel jitter: shift NDC by (dx,dy). With row-vector clip and
        # clip.w = -z_view = z_view * P[2][3], adding k to P[2][c] adds
        # k * z_view to clip[c]; to get clip[c] += d * clip.w we need
        # k = d * P[2][3] = -d.  (jx right / jy down in pixels; NDC y is up.)
        dx_ndc = jxy[0] * 2.0 / self.width
        dy_ndc = -jxy[1] * 2.0 / self.height
        proj[2, 0] += -dx_ndc
        proj[2, 1] += -dy_ndc

        vp = view @ proj
        vp_nj = view @ proj_nj
        planes = cmath.frustum_planes(vp_nj)
        prev = self._prev_vp_nj if self._prev_vp_nj is not None else vp_nj
        self._prev_vp_nj = vp_nj

        f32 = lambda a: np.ascontiguousarray(a, np.float32)
        return ViewUniform(
            translated_world_to_view=f32(view),
            view_to_clip=f32(proj),
            translated_world_to_clip=f32(vp),
            translated_world_to_clip_nojitter=f32(vp_nj),
            prev_translated_world_to_clip_nojitter=f32(prev),
            frustum_planes=f32(planes),
            camera_world_pos=self.position.copy(),
            render_size=(self.width, self.height),
            z_near=self.z_near,
            fovy=float(fovy),
            jitter=f32(jxy),
            frame_index=frame_index,
        )

    def rebase_matrix(self, local_to_world: np.ndarray) -> np.ndarray:
        """localToWorld (f64) → localToTranslatedWorld (f32): subtract the f64
        camera position from the translation row before the f32 cast."""
        m = np.array(local_to_world, np.float64)
        m[3, :3] -= self.position
        return np.ascontiguousarray(m, np.float32)
