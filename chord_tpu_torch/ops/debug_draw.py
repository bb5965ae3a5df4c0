"""Debug line rendering: wireframe overlays (port of
chord_tpu/ops/debug_draw.py; reference renderer/debugline.cpp).

Lines are rasterized densely: over chunks of CHUNK segments, each pixel
keeps its least squared distance to a segment, then a 1-px feathered
coverage blends the line colour over the image. The shape helpers build
segments on the host (AABB edges, sphere great circles).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

CHUNK = 32   # segments per step (keeps the (H,W,CHUNK) plane small)


def aabb_segments(mn, mx) -> np.ndarray:
    """(12, 2, 3) edges of an axis-aligned box."""
    mn = np.asarray(mn, np.float32)
    mx = np.asarray(mx, np.float32)
    c = np.array([[mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
                  [mx[0], mx[1], mn[2]], [mn[0], mx[1], mn[2]],
                  [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
                  [mx[0], mx[1], mx[2]], [mn[0], mx[1], mx[2]]], np.float32)
    e = [(0, 1), (1, 2), (2, 3), (3, 0),
         (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.stack([np.stack([c[a], c[b]]) for a, b in e])


def sphere_segments(center, radius: float, segs: int = 24) -> np.ndarray:
    """(3*segs, 2, 3): three axis-aligned great circles."""
    center = np.asarray(center, np.float32)
    t = np.linspace(0.0, 2.0 * np.pi, segs + 1, dtype=np.float32)
    ca, sa = np.cos(t) * radius, np.sin(t) * radius
    zero = np.zeros_like(ca)
    rings = [np.stack([ca, sa, zero], -1),    # xy
             np.stack([ca, zero, sa], -1),    # xz
             np.stack([zero, ca, sa], -1)]    # yz
    return np.concatenate([np.stack([(r + center)[:-1], (r + center)[1:]], 1)
                           for r in rings])


def project_segments(segs_world: torch.Tensor, tw_to_clip: torch.Tensor,
                     width: int, height: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,2,3) translated-world segments -> ((N,2,2) pixel endpoints, (N,)
    valid). A segment with an endpoint behind the camera is dropped (no
    clipping)."""
    p, m = segs_world, tw_to_clip
    c = p[..., 0:1] * m[0] + p[..., 1:2] * m[1] + p[..., 2:3] * m[2] + m[3]
    ok = torch.all(c[..., 3] > 1e-4, dim=-1)
    wc = torch.clamp_min(c[..., 3:4], 1e-4)
    x = (c[..., 0:1] / wc * 0.5 + 0.5) * width
    y = (0.5 - c[..., 1:2] / wc * 0.5) * height
    return torch.cat([x, y], -1), ok


def overlay_lines(image: torch.Tensor, segments_px: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  color=(0.1, 1.0, 0.2), width_px: float = 1.0
                  ) -> torch.Tensor:
    """Composite anti-aliased segments ((N,2,2) pixel endpoints) over an
    (H,W,3) image."""
    h, w = image.shape[:2]
    dev = image.device
    n = segments_px.shape[0]
    pad = (-n) % CHUNK
    segs = torch.cat([segments_px, torch.full((pad, 2, 2), -1e6,
                                              dtype=segments_px.dtype,
                                              device=dev)])
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    val = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                        device=dev)])
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
    best = torch.full((h, w), 1e12, dtype=torch.float32, device=dev)
    for s, ok in zip(segs.split(CHUNK), val.split(CHUNK)):
        ax, ay = s[:, 0, 0], s[:, 0, 1]
        bx, by = s[:, 1, 0], s[:, 1, 1]
        dx, dy = bx - ax, by - ay
        len2 = torch.clamp_min(dx * dx + dy * dy, 1e-6)
        # per pixel the closest point's t on each segment: (H,W,CHUNK)
        t = torch.clamp(((px - ax) * dx + (py - ay) * dy) / len2, 0.0, 1.0)
        qx = ax + t * dx - px
        qy = ay + t * dy - py
        d2 = torch.where(ok, qx * qx + qy * qy,
                         torch.full((), 1e12, device=dev))
        best = torch.minimum(best, d2.amin(-1))
    # a 1-px feathered coverage from the distance
    cov = torch.clamp(1.0 - (torch.sqrt(best) - width_px * 0.5), 0.0,
                      1.0)[..., None]
    col = torch.tensor(color, dtype=image.dtype, device=dev)
    return image * (1.0 - cov) + col * cov
