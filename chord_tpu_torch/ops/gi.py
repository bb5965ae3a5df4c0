"""Global illumination: the world radiance cache (SH3 clipmap cascades),
screen-space AO and ray-traced AO over the scene BVH (port of
chord_tpu/ops/gi.py; reference renderer/gi/screen_probe_gather.cpp:182
giUpdate, shader/gi.h:21-381, gi_rt_ao.hlsl).

The cache is (cascades, D^3, 28): per probe 27 SH3 floats (rgb-major
blocks of 9, ops/sh.py's basis) and a weight, with toroidal world-anchored
addressing (probe (i,j,k) of cascade c holds world cell floor(pos/voxel)
mod D). Injection splats lit surfels (or, in probe mode, the screen
probes, ops/screen_probe.py) with a scatter-add into a table with one
extra drop row. The scatter is `index_put_(accumulate=True)`: on a CUDA
tensor PyTorch sorts the indices and sums each run in order, so the cache
does not change from run to run, and the sum order is the CPU's.

The round-robin cascade (one a frame) is chosen on the host from the
frame counter (`frame_index`); chord_tpu switches on the traced counter.
Arithmetic on the counter (the injection jitter) stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

import numpy as np

from . import _util, rt
from . import sh as sh_ops
from ._util import const, dot3, f2i, norm3, recip
from .bluenoise import interleaved_gradient_noise
from .post import upsample_nearest


class GIConfig(NamedTuple):
    """chord_tpu GIConfig (reference r.gi.worldcache.* cvars)."""

    cascades: int = 4           # reference default 8
    probe_dim: int = 32         # probes per axis per cascade
    base_voxel: float = 0.5     # finest cascade voxel size (world units)
    inject_stride: int = 8      # gbuffer subsampling for injection
    inject_round_robin: bool = True   # one cascade per frame
    inject_jitter: bool = True  # cycle the subsample phase per frame
    temporal_alpha: float = 0.06   # cache update rate per frame
    intensity: float = 1.0
    sample_res_div: int = 8     # irradiance / specular sampled at 1/8 res
    trilinear: bool = False     # False = nearest probe
    ao_radius: float = 1.0
    ao_samples: int = 8
    ao_strength: float = 1.0
    ao_res_div: int = 2         # SSAO at 1/div res + upsample
    ao_mode: str = "ssao"       # "ssao" | "rtao" (rays against the BVH)
    rtao_rays: int = 4          # hemisphere rays per pixel (rtao)


SH0 = 0.2820948
SH1 = 0.4886025
NSH = 9            # SH3 coefficients per channel
NFL = NSH * 3      # SH floats per probe (rgb-major blocks of 9)
ROW = NFL + 1      # + weight channel


def sh_size(cfg: GIConfig) -> Tuple[int, ...]:
    """Cache shape: (cascades, D^3, 28)."""
    return (cfg.cascades, cfg.probe_dim ** 3, ROW)


def _probe_coords(pos_w: torch.Tensor, cascade: int, cfg: GIConfig,
                  anchor_w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World position -> (continuous cell coords, in-bounds mask) in a
    cascade. The voxel is a device constant: CUDA's tensor / scalar
    multiplies by the reciprocal, and a cell edge must round as XLA's."""
    voxel = const(cfg.base_voxel * (2.0 ** cascade), pos_w.device)
    g = pos_w / voxel
    rel = g - anchor_w / voxel
    half = cfg.probe_dim * 0.5
    inb = (torch.abs(rel) < (half - 1.5)).all(dim=-1)
    return g, inb


def _wrap_index(cell: torch.Tensor, cfg: GIConfig) -> torch.Tensor:
    """Integer cell coords (..., 3) -> flat toroidal probe index."""
    d = cfg.probe_dim
    w = torch.remainder(cell, d)
    return (w[..., 0] * d + w[..., 1]) * d + w[..., 2]


def splat_cascade(cache: torch.Tensor, c: int, pos: torch.Tensor,
                  flat: torch.Tensor, ok: torch.Tensor, cfg: GIConfig,
                  alpha: float, anchor: torch.Tensor) -> torch.Tensor:
    """Scatter-add rows `flat` (N, 27) at the nearest probes of cascade c
    into a fresh table (rows not `ok` or out of bounds into its drop row),
    then blend the per-probe mean into cache[c] at rate `alpha`, in place.
    chord_tpu inject_surfels' loop body and screen_probe._inject_cascade
    (the latter with twice the rate and the camera anchor)."""
    g, inb = _probe_coords(pos, c, cfg, anchor)
    use = ok & inb
    cell = f2i(torch.floor(g + 0.5))
    d3 = cfg.probe_dim ** 3
    idx = torch.where(use, _wrap_index(cell, cfg), d3).long()
    zero = torch.zeros((), device=pos.device)
    payload = torch.cat([torch.where(use[:, None], flat, zero),
                         use.float()[:, None]], dim=1)
    upd = torch.zeros((d3 + 1, ROW), device=pos.device).index_put_(
        (idx,), payload, accumulate=True)[:-1]
    cnt = torch.clamp_min(upd[:, NFL:ROW], 1e-6)
    mean = upd[:, :NFL] / cnt
    has = (upd[:, NFL:ROW] > 0.0).float()
    a = alpha * has
    new_sh = cache[c, :, :NFL] * (1.0 - a) + mean * a
    new_w = torch.clamp_max(cache[c, :, NFL:ROW] + has, 64.0)
    cache[c] = torch.cat([new_sh, new_w], dim=1)
    return cache


def inject_surfels(cache: torch.Tensor, pos_w: torch.Tensor,
                   radiance: torch.Tensor, normal: torch.Tensor,
                   valid: torch.Tensor, cam_pos: torch.Tensor,
                   cfg: GIConfig, only_cascade: Optional[int] = None
                   ) -> torch.Tensor:
    """Splat lit surfels (N,3 each; valid (N,)) into every cascade, or only
    `only_cascade` (a host int), with the temporal blend -> new cache. The
    radiance a probe receives travels along the surfel normal's opposite
    (exact for probes in front of the surface)."""
    y = sh_ops.sh_basis(-normal)                        # (N,9)
    contrib = radiance[:, None, :] * y[:, :, None]      # (N,9,3)
    flat = contrib.permute(0, 2, 1).reshape(-1, NFL)    # rgb-major
    cascades = (range(cfg.cascades) if only_cascade is None
                else [only_cascade])
    out = cache.clone()
    for c in cascades:
        splat_cascade(out, c, pos_w, flat, valid, cfg, cfg.temporal_alpha,
                      cam_pos)
    return out


def propagate(cache: torch.Tensor, cfg: GIConfig) -> torch.Tensor:
    """One Jacobi diffusion step: each probe blends toward the mean of its
    lit 6-neighbours (the reference's SHPropagate pass); unlit probes adopt
    them."""
    d = cfg.probe_dim
    vol = cache[:, :, :NFL].reshape(cfg.cascades, d, d, d, NFL)
    wgt = cache[:, :, NFL:].reshape(cfg.cascades, d, d, d, 1)
    lit = (wgt > 0).float()
    acc = torch.zeros_like(vol)
    wacc = torch.zeros_like(wgt)
    for axis in (1, 2, 3):
        for shift in (-1, 1):
            acc = acc + torch.roll(vol * lit, shift, axis) * \
                torch.roll(lit, shift, axis)
            wacc = wacc + torch.roll(lit, shift, axis)
    neighbor_mean = acc / torch.clamp_min(wacc, 1e-6)
    zero = torch.zeros((), device=cache.device)
    half = torch.where(wacc > 0, 0.5, zero)
    blend = torch.where(wgt > 0, 0.1, half)
    vol = vol * (1 - blend) + neighbor_mean * blend
    new_w = torch.maximum(wgt, half)
    return torch.cat([vol.reshape(cfg.cascades, d ** 3, NFL),
                      new_w.reshape(cfg.cascades, d ** 3, 1)], dim=2)


def _sh_dot(sh: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Rgb-major SH rows (..., 27) . basis (..., 9) -> (..., 3), each
    9-term dot summed in order, as XLA's CPU build sums chord_tpu's
    jnp.sum over a short minor axis."""
    p = sh[..., :NFL].reshape(sh.shape[:-1] + (3, NSH)) * basis[..., None, :]
    s = p[..., 0]
    for i in range(1, NSH):
        s = s + p[..., i]
    return s


def sample_irradiance(cache: torch.Tensor, pos_w: torch.Tensor,
                      normal: torch.Tensor, cam_pos: torch.Tensor,
                      cfg: GIConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (irradiance (...,3) AP1, confidence (...,)) from the finest
    in-bounds cascade: nearest probe, or trilinear over 8, cosine-lobe SH3
    evaluation."""
    dev = normal.device
    basis = sh_ops.sh_basis(normal) * const(tuple(sh_ops.A_BAND.tolist()),
                                            dev)
    lead = normal.shape[:-1]
    irr = torch.zeros(lead + (3,), device=dev)
    conf = torch.zeros(lead, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    for c in range(cfg.cascades):
        g, inb = _probe_coords(pos_w, c, cfg, cam_pos)
        if cfg.trilinear:
            base = torch.floor(g)
            frac = g - base
            acc = torch.zeros(lead + (NFL,), device=dev)
            wacc = torch.zeros(lead, device=dev)
            bi = f2i(base)
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        idx = _wrap_index(torch.stack(
                            [bi[..., 0] + dx, bi[..., 1] + dy,
                             bi[..., 2] + dz], dim=-1), cfg)
                        probe = cache[c][idx.long()]
                        tw = ((frac[..., 0] if dx else 1 - frac[..., 0]) *
                              (frac[..., 1] if dy else 1 - frac[..., 1]) *
                              (frac[..., 2] if dz else 1 - frac[..., 2]))
                        has = (probe[..., NFL] > 0.5).float()
                        acc = acc + probe[..., :NFL] * (tw * has)[..., None]
                        wacc = wacc + tw * has
        else:
            cell = f2i(torch.floor(g + 0.5))
            probe = cache[c][_wrap_index(cell, cfg).long()]
            has = (probe[..., NFL] > 0.5).float()
            acc = probe[..., :NFL] * has[..., None]
            wacc = has
        e = _sh_dot(acc / torch.clamp_min(wacc[..., None], 1e-6), basis)
        use = inb & ~done & (wacc > 0.1)
        irr = torch.where(use[..., None], torch.clamp_min(e, 0.0), irr)
        conf = torch.where(use, torch.clamp(wacc, 0.0, 1.0), conf)
        done = done | use
    return irr * cfg.intensity, conf


def sample_radiance(cache: torch.Tensor, pos_w: torch.Tensor,
                    direction: torch.Tensor, cam_pos: torch.Tensor,
                    cfg: GIConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (radiance (...,3), confidence (...,)): SH3 radiance of the
    nearest probe of the finest in-bounds cascade along `direction` (the
    rough-lobe fallback of the specular trace)."""
    dev = direction.device
    basis = sh_ops.sh_basis(direction)
    lead = direction.shape[:-1]
    rad = torch.zeros(lead + (3,), device=dev)
    conf = torch.zeros(lead, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    one = torch.ones((), device=dev)
    for c in range(cfg.cascades):
        g, inb = _probe_coords(pos_w, c, cfg, cam_pos)
        cell = f2i(torch.floor(g + 0.5))
        probe = cache[c][_wrap_index(cell, cfg).long()]
        e = _sh_dot(probe[..., :NFL], basis)
        use = inb & ~done & (probe[..., NFL] > 0.5)
        rad = torch.where(use[..., None], torch.clamp_min(e, 0.0) * torch.pi,
                          rad)
        conf = torch.where(use, one, conf)
        done = done | use
    return rad * cfg.intensity, conf


SSAO_TAPS = [(1, 3), (3, -1), (-2, 2), (-3, -3), (2, 6), (6, -2), (-5, 4),
             (-6, -6)]


def ssao(depth: torch.Tensor, pos_tw: torch.Tensor, normal: torch.Tensor,
         cfg: GIConfig, frame_index=None) -> torch.Tensor:
    """Horizon-style screen-space AO from fixed-offset neighbour taps
    (shifted planes) -> (H,W) in [0,1]. `depth` and `frame_index` are
    chord_tpu's signature; neither is read."""
    del depth, frame_index
    occ = torch.zeros(pos_tw.shape[:2], device=pos_tw.device)
    taps = SSAO_TAPS[:cfg.ao_samples]
    for dy, dx in taps:
        d = torch.roll(pos_tw, (dy, dx), (0, 1)) - pos_tw
        dist = norm3(d)
        dirn = d / torch.clamp_min(dist[..., None], 1e-6)
        s = dot3(dirn, normal)
        a = torch.clamp(s - 0.1, 0.0, 1.0) * \
            torch.clamp(1.0 - dist * recip(cfg.ao_radius), 0.0, 1.0)
        occ = occ + a
    ao = 1.0 - cfg.ao_strength * occ / len(taps)
    return torch.clamp(ao, 0.0, 1.0)


def rtao(pos_tw: torch.Tensor, normal: torch.Tensor, bvh: rt.SceneBVH,
         cfg: GIConfig, frame_index=None) -> torch.Tensor:
    """Ray-traced AO (reference gi_rt_ao.hlsl) -> (H,W) in [0,1]:
    rtao_rays rays a pixel from 0.05 above the surface, out to ao_radius,
    each hit occluding by 1 - t / ao_radius. The rays are a golden-angle
    fan (cos(elevation) = sqrt((i + 0.5) / k)) about the normal in a
    branchless tangent basis (Duff et al.), its azimuth turned per pixel
    by the interleaved gradient noise of `frame_index` (the device frame
    counter; None = no turn). A sphere BVH's proxies poke above flat
    neighbours and read as occlusion: a triangle BVH is the one to use."""
    h, w = normal.shape[:2]
    dev = normal.device
    n = normal
    s = torch.where(n[..., 2] >= 0.0, const(1.0, dev), const(-1.0, dev))
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]],
                     -1)
    t2 = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    rot = (interleaved_gradient_noise(h, w, frame_index, device=dev) *
           2.0 * np.pi if frame_index is not None
           else torch.zeros((h, w), device=dev))
    occ = torch.zeros((h, w), device=dev)
    k = max(cfg.rtao_rays, 1)
    org = pos_tw + n * 0.05
    radius = const(cfg.ao_radius, dev)
    zero = torch.zeros((), device=dev)
    for i in range(k):
        phi = rot + (i + 0.5) * (np.pi * (3.0 - np.sqrt(5.0)))
        ct = np.float32(np.sqrt((i + 0.5) / k))        # cos(elevation)
        st = np.float32(np.sqrt(1.0 - ct * ct))
        sin_p, cos_p = _util.sincosf(phi)
        d = (t1 * (cos_p * float(st))[..., None] +
             t2 * (sin_p * float(st))[..., None] + n * float(ct))
        t_hit, leaf = rt.trace(org, d, bvh, t_max=cfg.ao_radius)
        occ = occ + torch.where(
            leaf >= 0, torch.clamp(1.0 - t_hit / radius, 0.0, 1.0), zero)
    ao = 1.0 - cfg.ao_strength * occ / const(float(k), dev)
    return torch.clamp(ao, 0.0, 1.0)


def _down(x: torch.Tensor, k: int) -> torch.Tensor:
    return x[::k, ::k]


def diffuse_gi(cache: torch.Tensor, gbuf, cam_pos_w: torch.Tensor,
               cfg: GIConfig) -> torch.Tensor:
    """-> (H,W,3) indirect diffuse irradiance (before albedo) from the
    cache, sampled at 1/sample_res_div res and nearest-upsampled."""
    k = cfg.sample_res_div
    irr_q, conf_q = sample_irradiance(cache, _down(gbuf.position_tw, k),
                                      _down(gbuf.normal, k), cam_pos_w, cfg)
    h, w = gbuf.valid.shape
    irr = upsample_nearest(irr_q * conf_q[..., None], k, h, w)
    return torch.where(gbuf.valid[..., None], irr,
                       torch.zeros((), device=irr.device))


def _strided_roll(a: torch.Tensor, oy, ox, s: int) -> torch.Tensor:
    """roll(a, (-oy, -ox))[::s, ::s] for device-side shifts: element
    (i, j) is a[(i*s + oy) % H, (j*s + ox) % W]."""
    h, w = a.shape[:2]
    dev = a.device
    rows = torch.remainder(torch.arange(0, h, s, device=dev) + oy, h)
    cols = torch.remainder(torch.arange(0, w, s, device=dev) + ox, w)
    return a[rows.long()][:, cols.long()]


def update_cache(cache: torch.Tensor, gbuf, lit_color: torch.Tensor,
                 cam_pos_w: torch.Tensor, cfg: GIConfig,
                 frame_count: Optional[torch.Tensor] = None,
                 frame_index: Optional[int] = None) -> torch.Tensor:
    """Inject the frame's shaded surfaces (subsampled every inject_stride
    pixels) + one propagation step -> new cache. `frame_count` (the
    device counter) drives the subsample jitter; with inject_round_robin,
    `frame_index` (its host copy) picks the one cascade injected and
    propagated this call (chord_tpu's dynamic slice)."""
    s = cfg.inject_stride
    if cfg.inject_jitter and frame_count is not None:
        # advance the phase once per full cascade round; x5 scrambles the
        # visit order (gcd(5, s^2) = 1 for power-of-two strides)
        j = torch.remainder(
            torch.div(frame_count, max(cfg.cascades, 1),
                      rounding_mode="floor") * 5, s * s)
        oy = torch.div(j, s, rounding_mode="floor")
        ox = torch.remainder(j, s)

        def sub(a):
            return _strided_roll(a, oy, ox, s)
    else:
        def sub(a):
            return a[::s, ::s]
    pos = sub(gbuf.position_tw).reshape(-1, 3)
    rad = sub(lit_color).reshape(-1, 3)
    nrm = sub(gbuf.normal).reshape(-1, 3)
    val = sub(gbuf.valid).reshape(-1)
    if not (cfg.inject_round_robin and frame_count is not None):
        return propagate(inject_surfels(cache, pos, rad, nrm, val, cam_pos_w,
                                        cfg), cfg)
    if frame_index is None:
        raise ValueError("the round-robin inject needs frame_index, the "
                         "host's copy of frame_count")
    only = frame_index % cfg.cascades
    cache = inject_surfels(cache, pos, rad, nrm, val, cam_pos_w, cfg,
                           only_cascade=only)
    # propagate only the cascade injected this frame
    cache[only:only + 1] = propagate(cache[only:only + 1],
                                     cfg._replace(cascades=1))
    return cache
