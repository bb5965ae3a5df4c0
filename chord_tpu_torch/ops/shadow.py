"""Cascaded shadow maps with PCSS soft shadows (port of
chord_tpu/ops/shadow.py; reference renderer.cpp:347-381, cascade_setup.hlsl,
pcss.hlsl:33-92).

Cascades are depth-only raster passes through the same rasterizer as the
main view (renderer/meshlet_frame.py render_shadow_cascade): one (R,R)
reverse-Z map per cascade, stacked (N,R,R). `fit_cascades` fits them on the
host (numpy), `fit_cascades_device` on the device from last frame's
valid-depth range.

PCSS evaluation is split in two:

    shadow_prepass  per pixel: projection into every cascade, the finest
                    containing cascade, the slope-scaled receiver bias and
                    the Poisson-disk rotation (cos/sin of the noise)
    pcss_plain      per pixel: the blocker search, the penumbra and the
                    variable-radius PCF over the cascade stack

`evaluate_shadow` (both, in plain PyTorch) is the plain version of kernel K6;
`evaluate_shadow_auto` runs the same prepass and then K6
(ops/shadow_kernel.py), which takes the plain half's place on a CUDA
tensor. Both halves see the prepass's tensors, so K6 and `pcss_plain` are
held to each other bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import math as cmath
from . import _util
from ._util import const, f2i


class ShadowConfig(NamedTuple):
    """reference: render_helper.h:463-510 CascadeShadowMapConfig (the
    fields and defaults of chord_tpu's ShadowConfig)."""

    cascade_count: int = 4
    resolution: int = 1024
    max_distance: float = 80.0       # view-space shadow range
    split_lambda: float = 0.8        # log/uniform split blend
    depth_bias: float = 2.0e-4       # constant receiver bias (reverse-Z)
    slope_bias: float = 3.0
    pcf_radius_px: float = 2.0       # base PCF radius (texels)
    pcss_blocker_samples: int = 5
    pcss_pcf_samples: int = 6
    light_size_world: float = 0.5    # virtual sun disk size for penumbra
    eval_res_div: int = 4            # PCSS at 1/4 res + upsample
    temporal: bool = True            # temporal mask accumulation
    temporal_alpha: float = 0.7      # history weight at zero residual
    temporal_phase: int = 2          # PCSS evaluates 1/phase^2 of the
                                     # eval-res pixels per frame
    jitter: bool = True              # per-pixel/per-frame Poisson rotation
    # chord_tpu's split shadow dispatch (a TPU worker-fault workaround);
    # None and False run the shadows inline, True is not ported
    pipelined: Optional[bool] = None
    depth_range_fit: bool = True     # device fit to last frame's depth range
    # PCSS through K6 (None = on the card); False asks for a separate
    # gather path, which the port has on the CPU only
    eval_kernel: Optional[bool] = None
    scroll: bool = True              # scrolled cascade cache
    scroll_refresh_n: int = 4        # every Nth refresh of a cascade is full


# Poisson disk (unit radius), the reference's fixed pattern
_POISSON = np.array([
    [-0.94201624, -0.39906216], [0.94558609, -0.76890725],
    [-0.09418410, -0.92938870], [0.34495938, 0.29387760],
    [-0.91588581, 0.45771432], [-0.81544232, -0.87912464],
    [-0.38277543, 0.27676845], [0.97484398, 0.75648379],
    [0.44323325, -0.97511554], [0.53742981, -0.47373420],
    [-0.26496911, -0.41893023], [0.79197514, 0.19090188],
    [-0.24188840, 0.99706507], [-0.81409955, 0.91437590],
    [0.19984126, 0.78641367], [0.14383161, -0.14100790],
], np.float32)

PCF_RADIUS_MAX = 16.0      # evaluate_shadow's clip of the PCF radius


def fit_cascades(view_forward: np.ndarray, sun_dir: np.ndarray,
                 cam_fovy: float, aspect: float, cfg: ShadowConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side cascade fit (translated world, camera at the origin) ->
    (tw_to_light (N,4,4) f32 row-vector matrices, splits (N+1,) f32 view
    distances). Practical split scheme, bounding sphere per frustum slice,
    texel-snapped light translation."""
    n = cfg.cascade_count
    near, far = 0.1, cfg.max_distance
    splits = [near]
    for i in range(1, n + 1):
        f = i / n
        log_d = near * (far / near) ** f
        uni_d = near + (far - near) * f
        splits.append(cfg.split_lambda * log_d +
                      (1 - cfg.split_lambda) * uni_d)
    splits = np.asarray(splits, np.float64)

    sun = cmath.normalize(np.asarray(sun_dir, np.float64))
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(sun, up)) > 0.95:
        up = np.array([1.0, 0.0, 0.0])

    fwd = cmath.normalize(np.asarray(view_forward, np.float64))
    tan_y = np.tan(cam_fovy * 0.5)
    tan_x = tan_y * aspect

    mats = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        d0, d1 = splits[i], splits[i + 1]
        corners = []
        for d in (d0, d1):
            for sx in (-1, 1):
                for sy in (-1, 1):
                    right = cmath.normalize(np.cross(fwd, up))
                    upv = np.cross(right, fwd)
                    corners.append(
                        fwd * d + right * (sx * tan_x * d) +
                        upv * (sy * tan_y * d))
        corners = np.asarray(corners)
        center = corners.mean(0)
        radius = float(np.linalg.norm(corners - center, axis=1).max())
        texel = 2.0 * radius / cfg.resolution
        # sun_dir points surface->sun; the light eye sits toward the sun
        light_view = cmath.look_at(center + sun * radius * 2.0, center, up)
        snapped = light_view.copy()
        snapped[3, 0] = np.floor(snapped[3, 0] / texel) * texel
        snapped[3, 1] = np.floor(snapped[3, 1] / texel) * texel
        proj = cmath.ortho_reverse_z(-radius, radius, -radius, radius,
                                     0.0, 4.0 * radius)
        mats[i] = np.float32(snapped @ proj)
    return mats, splits.astype(np.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (3 terms, summed left to right),
    its square root correctly rounded as XLA's and CUDA's are (through
    float64: torch's f32 sqrt on the CPU is off by an ulp on ~0.7% of
    values, and the fit's texel snap turns an ulp into a texel)."""
    ss = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]
    return torch.sqrt(ss.double()).float()


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def fit_cascades_device(view_forward: torch.Tensor, sun_dir: torch.Tensor,
                        tan_x: torch.Tensor, tan_y: torch.Tensor,
                        z_range: torch.Tensor, cfg: ShadowConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side cascade fit to a valid-depth view range (the reference's
    cascade_setup.hlsl): the host fit's split scheme, bounding sphere and
    texel snap on tensors. Under `cfg.scroll` the light eye z is quantized
    at radius/2 and the depth span is 6 radii, so a refresh differs from
    its cached map by a pure texel translation between z steps.
    -> (tw_to_light (N,4,4) f32, frustum planes (N,6,4) f32)."""
    n = cfg.cascade_count
    dev = view_forward.device
    f32 = dict(dtype=torch.float32, device=dev)
    near = torch.clamp(z_range[0], 0.1, cfg.max_distance * 0.5)
    far = torch.clamp(torch.maximum(z_range[1], near * 1.5 + 0.5),
                      max=cfg.max_distance)

    f = torch.arange(1, n + 1, **f32) / n
    log_d = near * torch.pow(far / near, f)
    uni_d = near + (far - near) * f
    splits = torch.cat([near[None], cfg.split_lambda * log_d +
                        (1 - cfg.split_lambda) * uni_d])          # (N+1,)

    sun = sun_dir / torch.clamp_min(_norm(sun_dir), 1e-8)
    # +x when the sun is near the zenith, else +y
    flip = (torch.abs(sun[1]) > 0.95).to(torch.float32)
    up = torch.stack([flip, 1.0 - flip, torch.zeros_like(flip)])

    fwd = view_forward / torch.clamp_min(_norm(view_forward), 1e-8)
    right = _cross(fwd, up)
    right = right / torch.clamp_min(_norm(right), 1e-8)
    upv = _cross(right, fwd)

    # frustum-slice corners of every cascade: (N,2 depths,2 x,2 y,3)
    d = torch.stack([splits[:-1], splits[1:]], 1)[:, :, None, None, None]
    sign = torch.arange(2, **f32) * 2.0 - 1.0                     # (-1, 1)
    sx = sign[None, None, :, None, None]
    sy = sign[None, None, None, :, None]
    corners = (fwd * d + right * (sx * tan_x * d) +
               upv * (sy * tan_y * d)).reshape(n, 8, 3)
    # the 8 corners summed left to right, as XLA reduces chord_tpu's
    # mean (torch's sum over that axis pairs them otherwise, and the
    # texel snap below turns the last bit into a one-texel shift)
    center = corners[:, 0]
    for i in range(1, 8):
        center = center + corners[:, i]
    center = center / 8.0                                         # (N,3)
    radius = _norm(corners - center[:, None]).amax(1)             # (N,)
    texel = 2.0 * radius / cfg.resolution

    # look_at(center + sun*2r, center, up), row-vector convention
    eye = center + sun[None] * (radius * 2.0)[:, None]
    fl = (-sun[None]).expand(n, 3)
    s = _cross(fl, up.expand(n, 3))
    s = s / torch.clamp_min(_norm(s), 1e-8)[:, None]
    u = _cross(s, fl)
    dot = lambda a, b: (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] +
                        a[:, 2] * b[:, 2])
    tx_ = torch.floor(-dot(eye, s) / texel) * texel
    ty_ = torch.floor(-dot(eye, u) / texel) * texel
    tz_ = dot(eye, fl)
    if cfg.scroll:
        tz_ = torch.floor(tz_ / (0.5 * radius)) * (0.5 * radius)
    zero = torch.zeros((n,), **f32)
    one = torch.ones((n,), **f32)
    view = torch.stack([
        torch.stack([s[:, 0], u[:, 0], -fl[:, 0], zero], -1),
        torch.stack([s[:, 1], u[:, 1], -fl[:, 1], zero], -1),
        torch.stack([s[:, 2], u[:, 2], -fl[:, 2], zero], -1),
        torch.stack([tx_, ty_, tz_, one], -1)], 1)                # (N,4,4)

    # ortho_reverse_z(-r, r, -r, r, 0, span*r): span 6 under scroll (the
    # quantized eye z sits up to r/2 further out), else 4
    span = 6.0 if cfg.scroll else 4.0
    inv_r = 1.0 / torch.clamp_min(radius, 1e-6)
    zr = 1.0 / (span * radius)
    proj = torch.zeros((n, 4, 4), **f32)
    proj[:, 0, 0] = inv_r
    proj[:, 1, 1] = inv_r
    proj[:, 2, 2] = zr
    proj[:, 3, 2] = span * radius * zr
    proj[:, 3, 3] = 1.0
    mats = (view[:, :, 0:1] * proj[:, None, 0] + view[:, :, 1:2] *
            proj[:, None, 1] + view[:, :, 2:3] * proj[:, None, 2] +
            view[:, :, 3:4] * proj[:, None, 3])

    # Gribb-Hartmann planes (row-vector): column combinations, normalized
    c0, c1, c2, c3 = (mats[:, :, i] for i in range(4))
    planes = torch.stack([c3 + c0, c3 - c0, c3 + c1, c3 - c1, c2, c3 - c2], 1)
    pn = torch.clamp_min(_norm(planes[..., :3]), 1e-12)[..., None]
    return mats, planes / pn


# --- PCSS ---------------------------------------------------------------------

class ShadowPrepass(NamedTuple):
    """Per-pixel inputs of the PCSS taps (K6 and pcss_plain)."""

    cascade: torch.Tensor      # (H,W) i32 finest containing cascade, -1 none
    u: torch.Tensor            # (H,W) f32 texel coordinates in that cascade
    v: torch.Tensor
    z_cmp: torch.Tensor        # (H,W) f32 biased receiver depth
    z_recv: torch.Tensor       # (H,W) f32 receiver depth
    ca: torch.Tensor           # (H,W) f32 disk rotation cos / sin
    sa: torch.Tensor
    depth_range: torch.Tensor  # (N,) f32 world z across [0,1] per cascade
    texel: torch.Tensor        # (N,) f32 world units per texel per cascade


def shadow_prepass(position_tw: torch.Tensor, normal: torch.Tensor,
                   sun_dir: torch.Tensor, tw_to_light: torch.Tensor, r: int,
                   cfg: ShadowConfig, noise: Optional[torch.Tensor] = None
                   ) -> ShadowPrepass:
    """Project every receiver into every cascade (its own cached fit
    matrix) and keep the finest containing one; the slope-scaled bias is
    one texel of depth error at the receiver's slope, in that cascade's
    depth units (chord_tpu shadow.py:219-262, 272-277)."""
    n = tw_to_light.shape[0]
    h, w = position_tw.shape[:2]
    dev = position_tw.device
    p = position_tw
    zeros = torch.zeros((h, w), dtype=torch.float32, device=dev)
    u, v, z_recv = zeros, zeros, zeros
    cascade = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    for i in reversed(range(n)):          # coarse -> fine; fine overwrites
        m = tw_to_light[i]
        lp = (p[..., 0:1] * m[0] + p[..., 1:2] * m[1] +
              p[..., 2:3] * m[2] + m[3])                  # ortho: w == 1
        ui = (lp[..., 0] * 0.5 + 0.5) * r
        vi = (0.5 - lp[..., 1] * 0.5) * r
        zi = lp[..., 2]
        cont = ((ui >= 1) & (ui < r - 1) & (vi >= 1) & (vi < r - 1) &
                (zi > 0.0) & (zi <= 1.0))
        u = torch.where(cont, ui, u)
        v = torch.where(cont, vi, v)
        z_recv = torch.where(cont, zi, z_recv)
        cascade = torch.where(cont, i, cascade)

    # the ortho projection encodes world units per NDC: m00 = 1/radius,
    # m22 = 1/depth span
    m00 = torch.abs(tw_to_light[:, 0, 0])
    m22 = torch.abs(tw_to_light[:, 2, 2])
    depth_range = 1.0 / torch.clamp_min(m22, 1e-9)
    texel = 2.0 / torch.clamp_min(m00, 1e-9) / r
    c = torch.clamp_min(cascade, 0).long()
    dr, tx = depth_range[c], texel[c]
    nol = torch.clamp(normal[..., 0] * sun_dir[0] +
                      normal[..., 1] * sun_dir[1] +
                      normal[..., 2] * sun_dir[2], 0.05, 1.0)
    tan_t = torch.sqrt(torch.clamp_min(1.0 - nol * nol, 0.0)) / nol
    bias = (cfg.depth_bias + cfg.slope_bias * torch.clamp(tan_t, max=4.0) *
            tx / torch.clamp_min(dr, 1e-6))
    if noise is not None:
        theta = noise * (2.0 * math.pi)
        sa, ca = _util.sincosf(theta)
    else:
        ca, sa = torch.ones_like(zeros), zeros
    return ShadowPrepass(cascade=cascade, u=u, v=v, z_cmp=z_recv + bias,
                         z_recv=z_recv, ca=ca, sa=sa,
                         depth_range=depth_range, texel=texel)


def pcss_offsets(cfg: ShadowConfig):
    """The fixed disk offsets, rounded to f32 (as Python floats): blocker
    taps _POISSON[s]*search_r, PCF taps _POISSON[s]*(1+s/n), the latter
    scaled per pixel by the PCF radius."""
    search_r = np.float32(cfg.pcf_radius_px * 3.0)
    blk = [tuple(float(x) for x in _POISSON[s % len(_POISSON)] * search_r)
           for s in range(cfg.pcss_blocker_samples)]
    pcf = [tuple(float(x) for x in _POISSON[s % len(_POISSON)] *
                 np.float32(1.0 + s / cfg.pcss_pcf_samples))
           for s in range(cfg.pcss_pcf_samples)]
    return blk, pcf


def _tap_sampler(shadow_maps: torch.Tensor, pre: ShadowPrepass,
                 tap_index: Optional[list]):
    """-> sample_depth(du, dv): each pixel's stack depth at (u+du, v+dv)
    of its cascade, truncated toward zero and clamped to the map."""
    r = shadow_maps.shape[-1]
    flat = shadow_maps.reshape(-1)
    base = torch.clamp_min(pre.cascade, 0) * (r * r)

    def sample_depth(du, dv):
        x = torch.clamp(f2i(pre.u + du), 0, r - 1)
        y = torch.clamp(f2i(pre.v + dv), 0, r - 1)
        idx = (base + y * r + x).long()
        if tap_index is not None:
            tap_index.append(idx)
        return flat[idx]

    return sample_depth


def pcf_radius(shadow_maps: torch.Tensor, pre: ShadowPrepass,
               cfg: ShadowConfig, tap_index: Optional[list] = None
               ) -> torch.Tensor:
    """pcss_plain's blocker search and penumbra -> (H,W) PCF radius in
    texels, in [1, PCF_RADIUS_MAX] (NaN stays NaN)."""
    sample_depth = _tap_sampler(shadow_maps, pre, tap_index)
    ca, sa = pre.ca, pre.sa
    blk, _ = pcss_offsets(cfg)
    zero = torch.zeros((), device=shadow_maps.device)
    blocker_sum = torch.zeros_like(pre.u)
    blocker_cnt = torch.zeros_like(pre.u)
    for o in blk:
        zs = sample_depth(o[0] * ca - o[1] * sa, o[0] * sa + o[1] * ca)
        is_blocker = zs > pre.z_cmp            # reverse-Z: nearer the light
        blocker_sum = blocker_sum + torch.where(is_blocker, zs, zero)
        blocker_cnt = blocker_cnt + is_blocker.float()
    avg_blocker = blocker_sum / torch.clamp_min(blocker_cnt, 1.0)

    cl = torch.clamp_min(pre.cascade, 0).long()
    delta_world = (torch.clamp_min(avg_blocker - pre.z_recv, 0.0) *
                   pre.depth_range[cl])
    penumbra = (delta_world * cfg.light_size_world /
                torch.clamp_min(pre.texel[cl], 1e-6))
    penumbra = torch.where(blocker_cnt > 0.0, penumbra, zero)
    return torch.clamp(cfg.pcf_radius_px + penumbra, 1.0, PCF_RADIUS_MAX)


def pcss_plain(shadow_maps: torch.Tensor, pre: ShadowPrepass,
               cfg: ShadowConfig, tap_index: Optional[list] = None
               ) -> torch.Tensor:
    """Plain version of kernel K6 -> (H,W) sun visibility in [0,1]: Poisson
    blocker search, similar-triangles penumbra (in world units through the
    cascade's depth span and texel size), variable-radius PCF; 1.0 outside
    every cascade. `tap_index`, when given, receives each tap's (H,W) flat
    index into the stack (what the taps read)."""
    pcf_r = pcf_radius(shadow_maps, pre, cfg, tap_index)
    sample_depth = _tap_sampler(shadow_maps, pre, tap_index)
    ca, sa = pre.ca, pre.sa
    _, pcf = pcss_offsets(cfg)
    lit = torch.zeros_like(pre.u)
    for o in pcf:
        zs = sample_depth((o[0] * ca - o[1] * sa) * pcf_r,
                          (o[0] * sa + o[1] * ca) * pcf_r)
        lit = lit + (pre.z_cmp >= zs).float()
    # a true division (PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, which rounds 5/6 differently)
    lit = lit / const(float(cfg.pcss_pcf_samples), lit.device)
    return torch.where(pre.cascade >= 0, lit,
                       torch.ones((), device=lit.device))


def evaluate_shadow(position_tw: torch.Tensor, normal: torch.Tensor,
                    sun_dir: torch.Tensor, shadow_maps: torch.Tensor,
                    tw_to_light: torch.Tensor, cfg: ShadowConfig,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> (H,W) sun visibility (chord_tpu evaluate_shadow): the prepass and
    the plain PCSS taps, per pixel, in PyTorch. Cascade selection is by
    containment against each cached map's own matrix, so stale round-robin
    cascades stay exact. `noise` (H,W) in [0,1) rotates the disk."""
    pre = shadow_prepass(position_tw, normal, sun_dir, tw_to_light,
                         shadow_maps.shape[-1], cfg, noise)
    return pcss_plain(shadow_maps, pre, cfg)


def evaluate_shadow_auto(position_tw: torch.Tensor, normal: torch.Tensor,
                         sun_dir: torch.Tensor, shadow_maps: torch.Tensor,
                         tw_to_light: torch.Tensor, cfg: ShadowConfig,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The frame's PCSS: the prepass, then kernel K6 on a CUDA tensor (its
    plain version on the CPU). `cfg.eval_kernel=False` asks for a gather
    path apart from the kernel, which exists on the CPU only."""
    from . import shadow_kernel

    if cfg.eval_kernel is False and shadow_maps.is_cuda:
        raise NotImplementedError(
            "ShadowConfig.eval_kernel=False: on the card the PCSS runs "
            "through kernel K6 only")
    pre = shadow_prepass(position_tw, normal, sun_dir, tw_to_light,
                         shadow_maps.shape[-1], cfg, noise)
    return shadow_kernel.pcss(shadow_maps, pre, cfg)
