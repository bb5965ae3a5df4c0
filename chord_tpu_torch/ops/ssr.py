"""Screen-space reflections, the specular GI trace (port of
chord_tpu/ops/ssr.py; reference renderer/gi/screen_probe_gather.cpp's
half-res specular trace).

Reflection rays march the reduced-res depth buffer in screen space with an
exponential step schedule; hits shade from the previous frame's lit colour
(one gather after the march, at the recorded hit coordinates); misses are
left to the caller's SH-cache fallback. chord_tpu's `lax.scan` over the
steps is a loop here.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ._util import f2i


class SSRConfig(NamedTuple):
    steps: int = 12
    thickness: float = 0.15      # NDC-depth hit thickness (reverse-Z)
    max_distance: float = 30.0   # world-units march length
    res_div: int = 4
    edge_fade: float = 0.15      # screen-border fade band (fraction)


def march_steps(cfg: SSRConfig) -> np.ndarray:
    """The ray parameters of the march (exponential schedule, f32)."""
    ts = np.cumsum(np.geomspace(0.08, 1.0, cfg.steps))
    return np.asarray(ts / ts[-1] * cfg.max_distance, np.float32)


def trace(depth_q: torch.Tensor, color_prev: torch.Tensor,
          pos_q: torch.Tensor, nrm_q: torch.Tensor, tw_to_clip: torch.Tensor,
          cfg: SSRConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """depth_q (h,w) reverse-Z, color_prev (H,W,3) last frame's lit colour,
    pos_q / nrm_q (h,w,3), tw_to_clip (4,4) -> (reflection colour (h,w,3),
    confidence (h,w))."""
    h, w = depth_q.shape
    fh, fw = color_prev.shape[:2]
    dev = depth_q.device
    v = -pos_q
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), 1e-6)
    r = 2.0 * (v * nrm_q).sum(-1, keepdim=True) * nrm_q - v
    m = tw_to_clip

    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    zero = torch.zeros((h, w), device=dev)
    hit_x, hit_y, hit_conf = zero, zero, zero
    for t in march_steps(cfg).tolist():
        p = pos_q + r * t
        c = (p[..., 0:1] * m[0] + p[..., 1:2] * m[1] + p[..., 2:3] * m[2] +
             m[3])
        wc = torch.clamp_min(c[..., 3], 1e-6)
        x = (c[..., 0] / wc * 0.5 + 0.5) * w
        y = (0.5 - c[..., 1] / wc * 0.5) * h
        z = c[..., 2] / wc
        on = ((x >= 0) & (x < w) & (y >= 0) & (y < h) & (c[..., 3] > 0) &
              (z > 0) & (z <= 1.0))
        xi = torch.clamp(f2i(x), 0, w - 1).long()
        yi = torch.clamp(f2i(y), 0, h - 1).long()
        scene_z = depth_q[yi, xi]
        # reverse-Z: the ray passed behind a surface within the band
        behind = ((z < scene_z) & (z > scene_z - cfg.thickness) &
                  (scene_z > 0.0))
        hit = on & behind & ~found
        bx = torch.minimum(x, w - x) / (w * cfg.edge_fade)
        by = torch.minimum(y, h - y) / (h * cfg.edge_fade)
        fade = torch.clamp(torch.minimum(bx, by), 0.0, 1.0)
        found = found | hit
        hit_x = torch.where(hit, x, hit_x)
        hit_y = torch.where(hit, y, hit_y)
        hit_conf = torch.where(hit, fade, hit_conf)
    fx = torch.clamp(f2i(hit_x * (fw / w)), 0, fw - 1).long()
    fy = torch.clamp(f2i(hit_y * (fh / h)), 0, fh - 1).long()
    hit_col = torch.where(found[..., None], color_prev[fy, fx],
                          torch.zeros((), device=dev))
    # grazing reflections toward the camera are unreliable on screen
    toward_cam = (r * v).sum(-1)
    return hit_col, hit_conf * torch.clamp(1.0 - toward_cam, 0.0, 1.0)
