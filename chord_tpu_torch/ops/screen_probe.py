"""Screen-probe GI: the Lumen-style two-level gather (port of
chord_tpu/ops/screen_probe.py without `trace_probes`, the per-ray depth
march of trace_mode="march"; reference renderer/gi/screen_probe_gather.cpp:
164-182, shader/gi.h:21-29 and :381-406).

Pass list: spawn (one probe per 8x8 tile at a per-frame-jittered pixel) ->
SH reprojection of last frame's probes -> the probe radiance samples
(`gather_probe_taps`: the neighbour probes' surfaces as emitters, from
last frame's lit colour, plus fixed sky taps) -> SH projection merged with
the history by sample count -> world-cache inject (one cascade a frame)
-> interpolate to half res (a weight-aware resize of the SH planes, then
cosine-lobe evaluation) -> history reprojection (`history_mode`: "tile"
runs kernel K4 through ops/tile_reproject.py; "global" and "gather" are
plain tensor code) -> depth/normal-weighted spatial filter -> bilateral 2x
upsample. The specular chain (GGX-sampled trace direction, firefly clamp,
spatial filter, temporal accumulation) runs at the specular sample res.

The frame counter enters as a device tensor wherever it is arithmetic
(the ray-set rotation, the spawn jitter): the rolls by a device shift are
gathers here. The world-cache cascade is the host's `frame_index`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import gi as gi_ops
from . import sh
from ._util import const, f2i
from .post import _linear_weights, _resample, upsample_linear, \
    upsample_nearest


class ScreenProbeConfig(NamedTuple):
    """chord_tpu ScreenProbeConfig."""

    tile: int = 8                # probe spacing in pixels
    trace_mode: str = "taps"     # "taps" | "march" (not ported)
    rays: int = 16               # rays per probe per frame (march)
    steps: int = 8               # march steps per ray
    max_distance: float = 40.0
    thickness: float = 0.08
    depth_div: int = 4
    max_samples: float = 64.0    # SH numSample cap (gi.h kGIMaxSampleCount)
    temporal_depth_tol: float = 0.06   # probe reprojection depth gate
    history_alpha: float = 0.9   # half-res history weight
    history_mode: str = "global"   # "global" | "tile" (K4) | "gather"
    sky_leak: float = 0.25       # r.gi.skylightleaking
    filter_taps: int = 2         # spatial filter radius (half-res pixels)
    intensity: float = 1.0


def _octahedral_dirs(n_side: int) -> np.ndarray:
    """(n_side^2, 3) unit dirs: octahedral map cell centres."""
    u = (np.arange(n_side) + 0.5) / n_side * 2.0 - 1.0
    uu, vv = np.meshgrid(u, u, indexing="ij")
    x = uu
    y = vv
    az = 1.0 - np.abs(x) - np.abs(y)
    xo = np.where(az >= 0, x, (1 - np.abs(y)) * np.sign(x + 1e-12))
    yo = np.where(az >= 0, y, (1 - np.abs(x)) * np.sign(y + 1e-12))
    d = np.stack([xo, yo, az], -1).reshape(-1, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _jitter_rotation(frame_count: torch.Tensor) -> torch.Tensor:
    """Per-frame 3x3 rotation (golden-angle azimuth + tilt) of the ray
    set, from the device counter."""
    f = frame_count.float()
    a = f * 2.3999632297286533          # golden angle
    b = f * 1.1
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    zero = torch.zeros((), device=f.device)
    one = torch.ones((), device=f.device)
    rz = torch.stack([torch.stack([ca, -sa, zero]),
                      torch.stack([sa, ca, zero]),
                      torch.stack([zero, zero, one])])
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cb, -sb]),
                      torch.stack([zero, sb, cb])])
    return rz @ rx


def probe_ray_dirs(probes: "ProbeState", frame_count: torch.Tensor,
                   cfg: ScreenProbeConfig) -> torch.Tensor:
    """The frame's per-probe ray set (Ph,Pw,R,3): jitter-rotated octahedral
    directions flipped into each probe's hemisphere."""
    ph, pw = probes.depth.shape
    r = cfg.rays
    base = const(tuple(map(tuple, _octahedral_dirs(int(np.sqrt(r))).tolist())),
                 probes.depth.device)
    dirs = (base @ _jitter_rotation(frame_count).T)[None, None]
    dirs = dirs.expand(ph, pw, r, 3)
    ndot = (dirs * probes.normal[..., None, :]).sum(-1, keepdim=True)
    return torch.where(ndot < 0.0, -dirs, dirs)


class ProbeState(NamedTuple):
    """Per-frame spawned probe attributes (GIScreenProbeSpawnInfo)."""

    pos_tw: torch.Tensor     # (Ph,Pw,3) probe surface position
    normal: torch.Tensor     # (Ph,Pw,3)
    depth: torch.Tensor      # (Ph,Pw) reverse-Z ndc depth
    valid: torch.Tensor      # (Ph,Pw) bool: the tile had geometry


def spawn_probes(gbuf, depth: torch.Tensor, frame_count: torch.Tensor,
                 cfg: ScreenProbeConfig) -> ProbeState:
    """One probe per tile at the in-tile pixel (oy, ox) of this frame
    (gi_screen_probe_spawn.hlsl); the phase walks every tile pixel over
    tile^2 frames."""
    t = cfg.tile
    j = torch.remainder(frame_count * 5, t * t)
    oy = torch.div(j, t, rounding_mode="floor")
    ox = torch.remainder(j, t)

    def sub(a):
        return gi_ops._strided_roll(a, oy, ox, t)

    return ProbeState(pos_tw=sub(gbuf.position_tw), normal=sub(gbuf.normal),
                      depth=sub(depth), valid=sub(gbuf.valid))


def _prev_pixel(p: torch.Tensor, pm: torch.Tensor, h: int, w: int):
    """Positions (...,3) through the previous view-projection ->
    (x, y in [0,w) x [0,h) pixel units, ndc z, clip w)."""
    c = (p[..., 0:1] * pm[0] + p[..., 1:2] * pm[1] + p[..., 2:3] * pm[2] +
         pm[3])
    wc = torch.clamp_min(c[..., 3], 1e-6)
    px = (c[..., 0] / wc * 0.5 + 0.5) * w
    py = (0.5 - c[..., 1] / wc * 0.5) * h
    return px, py, c[..., 2] / wc, c[..., 3]


def reproject_probe_sh(probes: ProbeState, prev_probe_sh: torch.Tensor,
                       prev_probe_depth: torch.Tensor,
                       prev_tw_to_clip: torch.Tensor,
                       history_valid: torch.Tensor, cfg: ScreenProbeConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temporal SH reprojection (gi_screen_probe_sh_reproject.hlsl): each
    probe's point in last frame's probe grid, that probe's SH, gated on
    depth consistency -> (sh (Ph,Pw,9,3), num_sample (Ph,Pw))."""
    ph, pw = probes.depth.shape
    px, py, z, cw = _prev_pixel(probes.pos_tw, prev_tw_to_clip, ph, pw)
    on = ((px >= 0) & (px < pw) & (py >= 0) & (py < ph) & (cw > 0) &
          probes.valid)
    xi = torch.clamp(f2i(px), 0, pw - 1).long()
    yi = torch.clamp(f2i(py), 0, ph - 1).long()
    prev = prev_probe_sh[yi, xi]
    prev_z = prev_probe_depth[yi, xi]
    ok = (on & (torch.abs(z - prev_z) < cfg.temporal_depth_tol) &
          (history_valid > 0.5))
    sh_prev, n_prev = sh.unpack(prev)
    zero = torch.zeros((), device=prev.device)
    return (torch.where(ok[..., None, None], sh_prev, zero),
            torch.where(ok, n_prev, zero))


TAP_OFFSETS = [(-2, 0), (2, 0), (0, -2), (0, 2),
               (-1, -1), (-1, 1), (1, -1), (1, 1),
               (-5, -2), (-5, 2), (5, -2), (5, 2),
               (-2, -6), (2, -6), (-2, 6), (2, 6)]

# fixed sky sample directions (upper hemisphere) for the miss term
_SKY_DIRS = np.array([[0, 1, 0],
                      [0.8, 0.6, 0], [-0.8, 0.6, 0],
                      [0, 0.6, 0.8], [0, 0.6, -0.8],
                      [0.55, 0.62, 0.55], [-0.55, 0.62, -0.55]],
                     np.float32)
_SKY_DIRS /= np.linalg.norm(_SKY_DIRS, axis=1, keepdims=True)


def gather_probe_taps(probes: ProbeState, scene_rad: torch.Tensor,
                      sky_ambient: torch.Tensor, cfg: ScreenProbeConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe radiance samples without a march: each probe reads its
    neighbours' spawned surface points (shifted planes) as diffuse
    emitters along the real probe -> surface directions, with last frame's
    lit colour at those probes (`scene_rad` (Ph,Pw,3)) as the incident
    radiance; fixed sky directions are appended as virtual taps.
    -> (radiance (Ph,Pw,S,3), dirs (Ph,Pw,S,3), weights (Ph,Pw,S))."""
    ph, pw = probes.depth.shape
    dev = scene_rad.device
    rads, dirs, ws = [], [], []
    for dy, dx in TAP_OFFSETS:
        tp = torch.roll(probes.pos_tw, (dy, dx), (0, 1))
        tr = torch.roll(scene_rad, (dy, dx), (0, 1))
        tv = torch.roll(probes.valid, (dy, dx), (0, 1))
        d = tp - probes.pos_tw
        dist = torch.linalg.vector_norm(d, dim=-1)
        dirn = d / torch.clamp_min(dist[..., None], 1e-6)
        # taps below the tangent plane see the probe's own surface from
        # behind; distant taps lose weight
        cosn = (dirn * probes.normal).sum(-1)
        w = ((tv & probes.valid & (dist > 1e-3) & (cosn > 0.05)).float() *
             torch.exp(-dist * 0.02))
        rads.append(tr)
        dirs.append(dirn)
        ws.append(w)
    sky = (sky_ambient * cfg.sky_leak * 2.0).expand(ph, pw, 3)
    sky_dirs = const(tuple(map(tuple, _SKY_DIRS.tolist())), dev)
    for k in range(_SKY_DIRS.shape[0]):
        rads.append(sky)
        dirs.append(sky_dirs[k].expand(ph, pw, 3))
        ws.append(torch.full((ph, pw), 0.6, device=dev))
    return (torch.stack(rads, dim=2), torch.stack(dirs, dim=2),
            torch.stack(ws, dim=2))


def project_and_merge(radiance: torch.Tensor, dirs: torch.Tensor,
                      probes: ProbeState, sh_hist: torch.Tensor,
                      n_hist: torch.Tensor, cfg: ScreenProbeConfig,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """SH-project this frame's samples (gi_screen_probe_project_sh.hlsl)
    and merge with the reprojected history by sample count (SH3_gi.add)
    -> packed (Ph,Pw,28)."""
    r = radiance.shape[-2]
    sh_new = sh.project(radiance, dirs, weights)
    zero = torch.zeros((), device=radiance.device)
    if weights is not None:
        n_new = torch.where(probes.valid,
                            torch.clamp_max(weights.sum(-1), float(r)), zero)
    else:
        n_new = torch.where(probes.valid, float(r), zero)
    n_tot = n_hist + n_new
    w_h = torch.where(n_tot > 0, n_hist / torch.clamp_min(n_tot, 1e-6), zero)
    merged = (sh_hist * w_h[..., None, None] +
              sh_new * (1.0 - w_h)[..., None, None])
    return sh.pack(merged, torch.clamp_max(n_tot, cfg.max_samples))


def inject_world_cache(cache: torch.Tensor, probe_sh: torch.Tensor,
                       probes: ProbeState, gi_cfg: gi_ops.GIConfig,
                       frame_index: Optional[int] = None) -> torch.Tensor:
    """Feed the converged screen probes (numSample > 8) into the world SH
    cache (gi_world_probe_sh_inject.hlsl), all 9 coefficients 1:1, at twice
    the surfel rate: every cascade, or cascade frame_index % cascades (a
    host int) -> new cache."""
    shc, n = sh.unpack(probe_sh)
    flat = shc.reshape(-1, 9, 3).permute(0, 2, 1).reshape(-1, gi_ops.NFL)
    pos = probes.pos_tw.reshape(-1, 3)
    ok = (probes.valid & (n > 8.0)).reshape(-1)
    cascades = (range(gi_cfg.cascades) if frame_index is None
                else [frame_index % gi_cfg.cascades])
    out = cache.clone()
    anchor = torch.zeros(3, device=cache.device)
    for c in cascades:
        _inject_cascade(out, c, pos, flat, ok, gi_cfg, anchor)
    return out


def _inject_cascade(cache, c, pos, flat, ok, gi_cfg, anchor):
    """One cascade of inject_world_cache, in place (probes converge faster
    than surfels: twice the temporal rate)."""
    return gi_ops.splat_cascade(cache, c, pos, flat, ok, gi_cfg,
                                gi_cfg.temporal_alpha * 2.0, anchor)


def _weighted_resize(planes: torch.Tensor, weight: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """Weight-aware bilinear resize resize(planes*w) / resize(w), invalid
    probes do not bleed in. A power-of-two upscale takes the cascaded 2x
    shift + lerp (post.upsample_linear); any other ratio the linear
    resampling matrices of jax.image.resize (post._linear_weights)."""
    h, w = out_hw
    ph, pw = weight.shape
    ky, kx = h / ph, w / pw
    num_in = planes * weight[..., None]
    if ky == kx and ky >= 1 and float(ky).is_integer() and \
            (int(ky) & (int(ky) - 1)) == 0:
        num = upsample_linear(num_in, int(ky), h, w)
        den = upsample_linear(weight, int(ky), h, w)
    else:
        dev = planes.device
        zero = const(0.0, dev)
        wy = _linear_weights(ph, h, const(h / ph, dev), zero, dev)
        wx = _linear_weights(pw, w, const(w / pw, dev), zero, dev)
        num = _resample(num_in, wy, wx)
        den = _resample(weight[..., None], wy, wx)[..., 0]
    return num / torch.clamp_min(den[..., None], 1e-4)


def interpolate_half(probe_sh: torch.Tensor, probes: ProbeState,
                     normal_half: torch.Tensor, valid_half: torch.Tensor,
                     cfg: ScreenProbeConfig) -> torch.Tensor:
    """Probe SH -> half-res diffuse irradiance (Hh,Wh,3)
    (gi_screen_probe_interpolate.hlsl): the SH planes resized to half res,
    then the cosine lobe at each pixel's normal."""
    hh, wh = normal_half.shape[:2]
    shc, n = sh.unpack(probe_sh)
    zero = torch.zeros((), device=probe_sh.device)
    w = torch.where(probes.valid, torch.clamp_max(n, cfg.max_samples), zero)
    planes = shc.reshape(shc.shape[:-2] + (27,))
    sh_half = _weighted_resize(planes, w, (hh, wh)).reshape(hh, wh, 9, 3)
    e = sh.eval_irradiance(sh_half, normal_half) / np.pi
    return torch.where(valid_half[..., None],
                       torch.clamp_min(e, 0.0) * cfg.intensity, zero)


def _roll_dev(x: torch.Tensor, dy, dx) -> torch.Tensor:
    """roll(roll(x, dy, 0), dx, 1) for device shifts (a gather)."""
    h, w = x.shape[:2]
    dev = x.device
    rows = torch.remainder(torch.arange(h, device=dev) - dy, h)
    cols = torch.remainder(torch.arange(w, device=dev) - dx, w)
    return x[rows.long()][:, cols.long()]


def _neighborhood_clamp(fresh: torch.Tensor, hist: torch.Tensor
                        ) -> torch.Tensor:
    """Clip the history to the fresh 4-neighbourhood's range, padded by
    half its width (+1e-3)."""
    lo = fresh
    hi = fresh
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nb = torch.roll(fresh, (dy, dx), (0, 1))
        lo = torch.minimum(lo, nb)
        hi = torch.maximum(hi, nb)
    pad = (hi - lo) * 0.5 + 1e-3
    return torch.clamp(hist, lo - pad, hi + pad)


def _pixel_history(prev: torch.Tensor, motion: torch.Tensor):
    """Nearest per-pixel reprojection of `prev` (h,w,C) along NDC motion
    -> (history, on-screen mask)."""
    h, w = prev.shape[:2]
    dev = prev.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    px = xs - motion[..., 0] * w * 0.5
    py = ys + motion[..., 1] * h * 0.5
    on = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    xi = torch.clamp(f2i(px), 0, w - 1).long()
    yi = torch.clamp(f2i(py), 0, h - 1).long()
    return prev[yi, xi], on


def history_reproject_half(diffuse: torch.Tensor, motion_half: torch.Tensor,
                           prev_diffuse: torch.Tensor,
                           history_valid: torch.Tensor,
                           cfg: ScreenProbeConfig,
                           disocclusion: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Temporal accumulation at half res (gi_history_reprojection.hlsl):
    reprojected history, clamped to the fresh 3x3 cross, blended at
    history_alpha. history_mode "tile": per-32x128-tile mean motion through
    kernel K4 (ops/tile_reproject.py), with a residual-lowered weight;
    "global": the mean screen motion, bilinear by rolls; "gather": the
    exact per-pixel nearest sample."""
    hh, wh = diffuse.shape[:2]
    if cfg.history_mode == "tile":
        from .tile_reproject import tile_reproject

        mot_px = torch.stack([motion_half[..., 0] * (wh * 0.5),
                              -motion_half[..., 1] * (hh * 0.5)], -1)
        hist, resid = tile_reproject(prev_diffuse, mot_px)
        on = torch.clamp(1.0 - resid * 0.25, 0.0, 1.0)
    elif cfg.history_mode == "global":
        mx = motion_half[..., 0].mean() * (wh * 0.5)
        my = -motion_half[..., 1].mean() * (hh * 0.5)
        ix = f2i(torch.floor(mx))
        iy = f2i(torch.floor(my))
        fx = mx - ix.float()
        fy = my - iy.float()
        hist = (_roll_dev(prev_diffuse, -iy, -ix) * (1 - fx) * (1 - fy) +
                _roll_dev(prev_diffuse, -iy, -ix - 1) * fx * (1 - fy) +
                _roll_dev(prev_diffuse, -iy - 1, -ix) * (1 - fx) * fy +
                _roll_dev(prev_diffuse, -iy - 1, -ix - 1) * fx * fy)
        rx = motion_half[..., 0] * (wh * 0.5) - mx
        ry = -motion_half[..., 1] * (hh * 0.5) - my
        resid = torch.sqrt(rx * rx + ry * ry)
        on = torch.clamp(1.0 - resid * 0.25, 0.0, 1.0)
    else:
        hist, on = _pixel_history(prev_diffuse, motion_half)
        on = on.float()
    hist = _neighborhood_clamp(diffuse, hist)
    a = cfg.history_alpha * history_valid * on
    if disocclusion is not None:
        a = a * (1.0 - disocclusion)
    return diffuse + (hist - diffuse) * a[..., None]


def spatial_filter_half(diffuse: torch.Tensor, depth_half: torch.Tensor,
                        normal_half: torch.Tensor, cfg: ScreenProbeConfig
                        ) -> torch.Tensor:
    """Separable depth/normal-weighted blur at half res
    (gi_spatial_filter_diffuse.hlsl X then Y), shifted-plane taps."""
    out = diffuse
    for axis in (1, 0):
        acc = out
        wacc = torch.ones(depth_half.shape, device=diffuse.device)
        for s in range(1, cfg.filter_taps + 1):
            for sign in (-1, 1):
                d2 = torch.roll(depth_half, s * sign, axis)
                n2 = torch.roll(normal_half, s * sign, axis)
                c2 = torch.roll(out, s * sign, axis)
                wd = torch.exp(-torch.abs(d2 - depth_half) * 64.0)
                wn = torch.clamp((n2 * normal_half).sum(-1), 0.0, 1.0) ** 4
                w = wd * wn * (0.7 ** s)
                acc = acc + c2 * w[..., None]
                wacc = wacc + w
        out = acc / wacc[..., None]
    return out


def bilateral_upsample(diffuse_half: torch.Tensor, depth_half: torch.Tensor,
                       normal_half: torch.Tensor, depth_full: torch.Tensor,
                       normal_full: torch.Tensor) -> torch.Tensor:
    """Parity-correct 4-tap bilateral 2x upsample (gi_upsample.hlsl): each
    full-res pixel blends its 4 surrounding half-res taps by bilinear x
    depth x normal weights, from 9 shifted planes -> (H,W,3)."""
    h, w = depth_full.shape
    dev = depth_full.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    even_y = (ys % 2 == 0)
    even_x = (xs % 2 == 0)
    # full row y samples half row v = (y+0.5)/2 - 0.5: even rows blend
    # (j-1, j) by (0.25, 0.75), odd rows (j, j+1) by (0.75, 0.25)
    q, tq = const(0.25, dev), const(0.75, dev)
    wy0 = torch.where(even_y, q, tq)
    wx0 = torch.where(even_x, q, tq)
    fields = torch.cat([diffuse_half, depth_half[..., None], normal_half],
                       dim=-1)
    planes = {(ry, rx): upsample_nearest(
        torch.roll(fields, (ry, rx), (0, 1)), 2, h, w)
        for ry in (1, 0, -1) for rx in (1, 0, -1)}
    eyb = even_y[..., None]
    exb = even_x[..., None]
    acc = torch.zeros((h, w, 3), device=dev)
    wacc = torch.zeros((h, w), device=dev)
    for ty in (0, 1):
        for tx in (0, 1):
            # y-shift: even rows 1-ty, odd rows -ty (same in x)
            t = torch.where(eyb & exb, planes[(1 - ty, 1 - tx)],
                            torch.where(eyb & ~exb, planes[(1 - ty, -tx)],
                                        torch.where(~eyb & exb,
                                                    planes[(-ty, 1 - tx)],
                                                    planes[(-ty, -tx)])))
            col, dep, nrm = t[..., 0:3], t[..., 3], t[..., 4:7]
            wb = ((wy0 if ty == 0 else 1.0 - wy0) *
                  (wx0 if tx == 0 else 1.0 - wx0))
            wd = torch.exp(-torch.abs(dep - depth_full) * 64.0)
            wn = torch.clamp((nrm * normal_full).sum(-1), 0.0, 1.0) ** 4
            wt = wb * (wd * wn + 1e-3)
            acc = acc + col * wt[..., None]
            wacc = wacc + wt
    return acc / torch.clamp_min(wacc[..., None], 1e-6)


# --- the specular chain (gi_spatial_specular_remove_fireflare.hlsl,
# gi_spatial_filter_specular.hlsl, the shared history reprojection), at
# the specular sample res -----------------------------------------------------

def _edge_weight(pos_c, nrm_c, pos_s, nrm_s, sharp: float = 8.0):
    """(normal factor ^ 8 x distance factor) ^ sharp."""
    nf = torch.clamp((nrm_c * nrm_s).sum(-1), 0.0, 1.0) ** 8
    scale = torch.clamp_min(torch.linalg.vector_norm(pos_c, dim=-1), 1e-3)
    df = torch.clamp(
        1.0 - torch.linalg.vector_norm(pos_s - pos_c, dim=-1) / scale,
        0.0, 1.0)
    return (nf * df) ** sharp


def ggx_sample_normal(nrm: torch.Tensor, view: torch.Tensor,
                      rough: torch.Tensor, u1: torch.Tensor,
                      u2: torch.Tensor) -> torch.Tensor:
    """GGX-importance-sampled microfacet normal (Walter07: theta_h =
    atan(a sqrt(u1/(1-u1))), a = rough^2) for the specular trace; the
    shading normal where reflecting about the sample would dive below the
    surface. It doubles as SSR's virtual normal."""
    a = torch.clamp_min(rough * rough, 1e-4)[..., None]
    u1c = torch.clamp(u1, 0.0, 0.999)[..., None]
    u2e = u2[..., None]
    t2 = (a * a) * u1c / (1.0 - u1c)
    cos_t = 1.0 / torch.sqrt(1.0 + t2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = (2.0 * np.pi) * u2e
    # branchless orthonormal basis (Duff et al.)
    dev = nrm.device
    s = torch.where(nrm[..., 2:3] >= 0.0, const(1.0, dev), const(-1.0, dev))
    c_ = -1.0 / (s + nrm[..., 2:3])
    b_ = nrm[..., 0:1] * nrm[..., 1:2] * c_
    t1v = torch.cat([1.0 + s * nrm[..., 0:1] ** 2 * c_, s * b_,
                     -s * nrm[..., 0:1]], -1)
    t2v = torch.cat([b_, s + nrm[..., 1:2] ** 2 * c_, -nrm[..., 1:2]], -1)
    h = (t1v * (torch.cos(phi) * sin_t) + t2v * (torch.sin(phi) * sin_t) +
         nrm * cos_t)
    h = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=-1,
                                                     keepdim=True), 1e-8)
    d = 2.0 * (view * h).sum(-1, keepdim=True) * h - view
    ok = (d * nrm).sum(-1, keepdim=True) > 1e-3
    return torch.where(ok, h, nrm)


def specular_firefly_clamp(spec: torch.Tensor, pos_q: torch.Tensor,
                           nrm_q: torch.Tensor, rough_q: torch.Tensor
                           ) -> torch.Tensor:
    """Firefly removal: an edge-aware centre-free neighbour mean (8
    shifted planes at strides 1 and 2), a downward luminance clamp to 4x
    that mean, a gentle blur, then an AABB clip toward the 4x4 tile mean
    with a roughness-lerped range. Mirror pixels (roughness 0) pass
    through."""
    dev = spec.device
    acc = torch.zeros_like(spec)
    wacc = torch.zeros(spec.shape[:2], device=dev)
    for s in (1, 2):
        for dy, dx in ((0, s), (0, -s), (s, 0), (-s, 0)):
            p2 = torch.roll(pos_q, (dy, dx), (0, 1))
            n2 = torch.roll(nrm_q, (dy, dx), (0, 1))
            c2 = torch.roll(spec, (dy, dx), (0, 1))
            w = _edge_weight(pos_q, nrm_q, p2, n2)
            acc = acc + c2 * w[..., None]
            wacc = wacc + w
    nb_mean = torch.where((wacc > 1e-5)[..., None],
                          acc / torch.clamp_min(wacc, 1e-5)[..., None], spec)
    lum = spec.amax(-1)
    nb_lum = nb_mean.amax(-1)
    factor = torch.clamp_max((nb_lum * 4.0 + 0.25) /
                             torch.clamp_min(lum, 1e-5), 1.0)
    cleaned = spec * factor[..., None]

    acc = cleaned
    wacc2 = torch.ones(spec.shape[:2], device=dev)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        p2 = torch.roll(pos_q, (dy, dx), (0, 1))
        n2 = torch.roll(nrm_q, (dy, dx), (0, 1))
        c2 = torch.roll(cleaned, (dy, dx), (0, 1))
        w = _edge_weight(pos_q, nrm_q, p2, n2)
        acc = acc + c2 * w[..., None]
        wacc2 = wacc2 + w
    blurred = acc / wacc2[..., None]

    # the 4x4 tile mean (the reference's 8x8 statSRV at this res)
    hq, wq = spec.shape[:2]
    t = 4
    ph, pw = -(-hq // t) * t, -(-wq // t) * t
    padded = torch.nn.functional.pad(blurred, (0, 0, 0, pw - wq, 0, ph - hq))
    cnt = torch.nn.functional.pad(torch.ones((hq, wq, 1), device=dev),
                                  (0, 0, 0, pw - wq, 0, ph - hq))
    stat = (padded.reshape(ph // t, t, pw // t, t, 3).sum((1, 3)) /
            torch.clamp_min(cnt.reshape(ph // t, t, pw // t, t, 1)
                            .sum((1, 3)), 1.0))
    stat_full = stat.repeat_interleave(t, 0).repeat_interleave(t, 1)[:hq, :wq]
    lf = torch.clamp(rough_q / 0.25, 0.0, 1.0)
    rng = (0.3 + 0.2 * lf)[..., None] * (
        torch.abs(stat_full).amax(-1, keepdim=True) + 0.25)
    clipped = torch.clamp(blurred, stat_full - rng, stat_full + rng)
    return torch.where(rough_q[..., None] <= 1e-4, spec, clipped)


def spatial_filter_specular(spec: torch.Tensor, pos_q: torch.Tensor,
                            nrm_q: torch.Tensor, rough_q: torch.Tensor,
                            taps: int = 3) -> torch.Tensor:
    """Separable edge-aware specular blur (X then Y) whose weight grows
    with roughness; mirror pixels keep the raw trace."""
    rad_w = torch.clamp(rough_q / 0.25, 0.0, 1.0)
    out = spec
    for axis in (1, 0):
        acc = out
        wacc = torch.ones(rough_q.shape, device=spec.device)
        for s in range(1, taps + 1):
            for sign in (-1, 1):
                p2 = torch.roll(pos_q, s * sign, axis)
                n2 = torch.roll(nrm_q, s * sign, axis)
                c2 = torch.roll(out, s * sign, axis)
                w = (_edge_weight(pos_q, nrm_q, p2, n2) * rad_w *
                     0.7 ** (s - 1))
                acc = acc + c2 * w[..., None]
                wacc = wacc + w
        out = acc / wacc[..., None]
    return out


def temporal_specular(spec: torch.Tensor, motion_q: torch.Tensor,
                      prev_spec: torch.Tensor, history_valid: torch.Tensor,
                      rough_q: torch.Tensor,
                      disocclusion: Optional[torch.Tensor] = None,
                      alpha: float = 0.85) -> torch.Tensor:
    """Temporal accumulation of the specular composite: the per-pixel
    reprojected history, neighbourhood-clamped; mirror pixels keep a
    shorter history."""
    hist, on = _pixel_history(prev_spec, motion_q)
    hist = _neighborhood_clamp(spec, hist)
    a_r = alpha * (0.5 + 0.5 * torch.clamp(rough_q / 0.25, 0.0, 1.0))
    a = a_r * history_valid * on.float()
    if disocclusion is not None:
        a = a * (1.0 - disocclusion)
    return spec + (hist - spec) * a[..., None]
