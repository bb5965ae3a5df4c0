"""DDGI clipmap light-probe volumes, the alternative GI path (port of
chord_tpu/ops/ddgi.py; reference renderer/gi/light_probe.cpp:65-664
ddgiUpdate, shader ddgi.h, ddgi_probe_trace / _convolution / _relocation
/ _relighting.hlsl; selected by r.gi.method, renderer.cpp:22-28).

Clipmap cascades of camera-centred probe grids (spacing x2 a cascade).
Each probe keeps octahedral irradiance texels (the 6x6 interior of the
reference's 8x8 map), Chebyshev (mean, mean^2) distance texels (8x8), an
L1 SH projection of its irradiance (the fast sampling path), a relocation
offset and an update weight. A frame updates one (cascade, phase) slice
of probes: spherical-Fibonacci rays, turned by a per-frame rotation, are
traced through the scene BVH (ops/rt.py, no kernel of its own), hits are
shaded from the BVH's leaf table, misses see the sky; the rays are
convolved into the texels, blended into the history by the hysteresis,
and a probe whose nearest hit lies inside its front-face shell steps away
from it. Sampling blends 8 probes trilinearly with wrap shading and
Chebyshev visibility.

chord_tpu picks the frame's (cascade, phase) slice by a dynamic slice on
the traced frame counter; here the host's `frame_index` picks it (as the
world cache's cascade, ops/gi.py), and the same index builds the frame's
rotated ray set on the host (ray_table), which rounds as chord_tpu's
compiled rotation does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import rt
from ._util import const, dot3, f2i, host_table, jitter_rays, norm3
from .post import upsample_nearest


class DDGIConfig(NamedTuple):
    """chord_tpu DDGIConfig (reference DDGIVoulmeConfig, ddgi.h:63-100,
    and light_probe.cpp:89-103)."""

    cascades: int = 4               # reference kDDGICsacadeCount = 8
    probe_dim: Tuple[int, int, int] = (16, 8, 16)   # reference (32,8,32)
    base_spacing: float = 1.0       # finest cascade spacing; x2 a cascade
    rays: int = 32                  # reference kDDGIPerProbeRayCount = 128
    irr_side: int = 6               # interior texels of the 8x8 map
    dist_side: int = 8              # interior texels of the 16x16 map
    hysteresis: float = 0.94
    distance_exponent: float = 10.0
    normal_bias: float = 0.2        # probeNormalBias (sampling)
    min_frontface: float = 0.3      # probeMinFrontfaceDistance (relocation)
    max_offset_frac: float = 0.45   # relocation clamp, share of the spacing
    update_phases: int = 4          # probes a frame = P / update_phases
    sample_div: int = 4             # sample at 1/div res + upsample
    sky_leak: float = 0.25          # miss radiance factor
    intensity: float = 1.0


def probe_count(cfg: DDGIConfig) -> int:
    dx, dy, dz = cfg.probe_dim
    return dx * dy * dz


class DDGIState(NamedTuple):
    """Per-probe history (the reference's irradiance / distance / offset
    textures and probe trace cache)."""

    irr: torch.Tensor      # (C,P,Ti^2,3) octahedral irradiance (AP1)
    dist: torch.Tensor     # (C,P,Td^2,2) octahedral (mean, mean^2) distance
    sh: torch.Tensor       # (C,P,12) L1 SH projection of irr (rgb-major)
    offset: torch.Tensor   # (C,P,3) relocation offset (world units)
    weight: torch.Tensor   # (C,P) updates accumulated (0 = never traced)

    @classmethod
    def empty(cls, cfg: Optional[DDGIConfig] = None,
              device=None) -> "DDGIState":
        """Zeroed state on `device` (None = the card); without `cfg`,
        chord_tpu's placeholder (one cascade of 2x2x2 probes, 2x2 maps)
        that a history carries when DDGI is off."""
        from ..utils.device import resolve

        cfg = cfg or DDGIConfig(cascades=1, probe_dim=(2, 2, 2), irr_side=2,
                                dist_side=2)
        c, p = cfg.cascades, probe_count(cfg)
        f32 = dict(dtype=torch.float32, device=resolve(device))
        return cls(irr=torch.zeros((c, p, cfg.irr_side ** 2, 3), **f32),
                   dist=torch.zeros((c, p, cfg.dist_side ** 2, 2), **f32),
                   sh=torch.zeros((c, p, 12), **f32),
                   offset=torch.zeros((c, p, 3), **f32),
                   weight=torch.zeros((c, p), **f32))


# --- direction parameterisations ---------------------------------------------

def spherical_fibonacci(n: int) -> np.ndarray:
    """(n,3) f32 unit directions, the reference's probe ray set
    (ddgi.h:165), computed in float64."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = 2.0 * np.pi * i * (1.0 / 1.6180339887498949)
    cos_t = 1.0 - 2.0 * i / n
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t * cos_t))
    return np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t,
                     cos_t], -1).astype(np.float32)


def octahedral_texel_dirs(side: int) -> np.ndarray:
    """(side^2, 3) f32 unit directions at the octahedral texel centres
    (full sphere)."""
    u = (np.arange(side) + 0.5) / side * 2.0 - 1.0
    uu, vv = np.meshgrid(u, u, indexing="ij")
    az = 1.0 - np.abs(uu) - np.abs(vv)
    xo = np.where(az >= 0, uu, (1 - np.abs(vv)) * np.sign(uu + 1e-12))
    yo = np.where(az >= 0, vv, (1 - np.abs(uu)) * np.sign(vv + 1e-12))
    d = np.stack([xo, yo, az], -1).reshape(-1, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def octahedral_texel_index(d: torch.Tensor, side: int) -> torch.Tensor:
    """Unit directions (...,3) -> the nearest interior texel's flat index
    (...,) i32 (octahedralEncode, ddgi.h:197, nearest in place of the
    border-padded bilinear fetch)."""
    dev = d.device
    s = torch.abs(d).sum(-1, keepdim=True)
    p = d[..., :2] / torch.clamp_min(s, 1e-9)
    neg = d[..., 2:3] < 0.0
    wrap = (1.0 - torch.abs(p.flip(-1))) * torch.where(
        p >= 0.0, const(1.0, dev), const(-1.0, dev))
    p = torch.where(neg, wrap, p)
    ij = torch.clamp(f2i((p * 0.5 + 0.5) * side), 0, side - 1)
    return ij[..., 0] * side + ij[..., 1]


# --- probe placement ---------------------------------------------------------

def probe_grid_positions(cfg: DDGIConfig) -> np.ndarray:
    """(P,3) f32 unit-spacing grid positions centred on the camera (the
    translated-world origin); times the cascade spacing in world."""
    dx, dy, dz = cfg.probe_dim
    g = np.stack(np.meshgrid(np.arange(dx) - (dx - 1) * 0.5,
                             np.arange(dy) - (dy - 1) * 0.5,
                             np.arange(dz) - (dz - 1) * 0.5, indexing="ij"),
                 -1)
    return g.reshape(-1, 3).astype(np.float32)


def ray_table(frame: int, rays: int) -> np.ndarray:
    """The frame's (R,3) f32 probe ray set: the Fibonacci rays rotated by
    the frame's jitter (golden-angle azimuth a = 2.39996 f, tilt b = 1.7 f
    about x: fib @ (Rz(a) Rx(b))^T, chord_tpu's _jitter_rotation), rounded
    as chord_tpu's compiled update rounds it and the same on every device
    (_util.jitter_rays)."""
    return jitter_rays(spherical_fibonacci(rays), frame, 1.7)


# --- update: trace -> relight -> convolve -> relocate ------------------------

def convolve_numpy(rad: np.ndarray, dist: np.ndarray, dirs: np.ndarray,
                   cfg: DDGIConfig):
    """numpy oracle of `_convolve` -> (irradiance (...,Ti,3), distance
    moments (...,Td,2))."""
    ti = octahedral_texel_dirs(cfg.irr_side)
    td = octahedral_texel_dirs(cfg.dist_side)
    wi = np.maximum(dirs @ ti.T, 0.0)                     # (...,R,Ti)
    wd = np.maximum(dirs @ td.T, 0.0) ** cfg.distance_exponent
    irr = (np.einsum("...rt,...rc->...tc", wi, rad) /
           np.maximum(wi.sum(-2)[..., None], 1e-6))
    dd = np.stack([dist, dist * dist], -1)
    dst = (np.einsum("...rt,...rc->...tc", wd, dd) /
           np.maximum(wd.sum(-2)[..., None], 1e-6))
    return irr, dst


@functools.lru_cache(maxsize=None)
def _table(name: str, n, device) -> torch.Tensor:
    """A direction or position table of this module on `device`, made
    once: octahedral texel dirs of side n, or the probe grid of config
    n."""
    make = {"texels": octahedral_texel_dirs,
            "grid": probe_grid_positions}[name]
    return torch.from_numpy(make(n)).to(device)


def _texel_dirs(side: int, device) -> torch.Tensor:
    return _table("texels", side, device)


def _convolve(rad: torch.Tensor, dist: torch.Tensor, dirs: torch.Tensor,
              cfg: DDGIConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine-lobe irradiance and power-lobe distance convolution of each
    probe's rays into its texels (ddgi_probe_convolution.hlsl), every
    texel against every ray: rad (Pp,R,3), dist (Pp,R), dirs (Pp,R,3) or
    (R,3) -> (irradiance (Pp,Ti,3), moments (Pp,Td,2))."""
    ti = _texel_dirs(cfg.irr_side, rad.device)
    td = _texel_dirs(cfg.dist_side, rad.device)
    if dirs.dim() == 2:
        dirs = dirs.expand(rad.shape[:1] + dirs.shape)
    wi = torch.clamp_min(torch.einsum("prc,tc->prt", dirs, ti), 0.0)
    wd = torch.clamp_min(torch.einsum("prc,tc->prt", dirs, td),
                         0.0) ** cfg.distance_exponent
    irr = (torch.einsum("prt,prc->ptc", wi, rad) /
           torch.clamp_min(wi.sum(1)[..., None], 1e-6))
    dd = torch.stack([dist, dist * dist], -1)               # (Pp,R,2)
    dst = (torch.einsum("prt,prc->ptc", wd, dd) /
           torch.clamp_min(wd.sum(1)[..., None], 1e-6))
    return irr, dst


SH0 = 0.2820948
SH1 = 0.4886025


def _project_sh(irr: torch.Tensor, cfg: DDGIConfig) -> torch.Tensor:
    """Octahedral irradiance texels (P,Ti,3) -> L1 SH (P,12), rgb-major:
    the fast sampling path's payload."""
    t = _texel_dirs(cfg.irr_side, irr.device)               # (T,3)
    y = torch.stack([torch.full((t.shape[0],), SH0, device=irr.device),
                     SH1 * t[:, 1], SH1 * t[:, 2], SH1 * t[:, 0]], -1)
    domega = 4.0 * np.pi / (cfg.irr_side ** 2)
    return torch.einsum("ptc,tk->pkc", irr, y).reshape(
        irr.shape[0], 12) * domega


def update_slice(cfg: DDGIConfig, frame_index: int) -> Tuple[int, int, int]:
    """The (cascade, first probe, probe count) a frame updates: cascade
    frame % cascades, phase (frame // cascades) % update_phases."""
    phases = max(1, cfg.update_phases)
    p = probe_count(cfg)
    if p % phases:
        raise ValueError("the probe count must divide by update_phases")
    pp = p // phases
    return (frame_index % cfg.cascades,
            (frame_index // cfg.cascades) % phases * pp, pp)


def ddgi_update(state: DDGIState, bvh: rt.SceneBVH,
                sun_direction: torch.Tensor, sun_radiance: torch.Tensor,
                sky_ambient: torch.Tensor, frame_count: torch.Tensor,
                cfg: DDGIConfig, frame_index: Optional[int] = None
                ) -> DDGIState:
    """One frame's probe update of one (cascade, phase) slice
    (update_slice of `frame_index`, the host's copy of `frame_count`):
    trace the frame's rotated Fibonacci rays (ray_table of `frame_index`,
    copied pinned and without a synchronisation) of each probe through the
    BVH (t_max 1e6), shade hits (shade_hits with half the sky as ambient),
    misses the sky times sky_leak, distances capped at 4 spacings;
    convolve, blend by the hysteresis (a never-traced probe takes the new
    texels whole), project to SH, and push a probe whose nearest hit lies
    within min_frontface spacings away from it, its offset clamped to
    max_offset_frac spacings -> new state."""
    if frame_index is None:
        raise ValueError("ddgi_update needs frame_index, the host's copy of "
                         "frame_count")
    dev = state.irr.device
    cascade, start, pp = update_slice(cfg, frame_index)
    sl = slice(start, start + pp)
    spacing = float(np.float32(cfg.base_spacing)) * 2.0 ** cascade
    grid = _table("grid", cfg, dev)
    off = state.offset[cascade, sl]
    pos = grid[sl] * spacing + off                            # (Pp,3)
    dirs = host_table(ray_table(frame_index, cfg.rays), dev)  # (R,3)
    org = pos[:, None, :].expand(pp, cfg.rays, 3)
    dir_b = dirs[None].expand(pp, cfg.rays, 3)
    t, leaf = rt.trace(org, dir_b, bvh, t_max=1e6)            # (Pp,R)
    hit = leaf >= 0
    rad, _ = rt.shade_hits(t, leaf, org, dir_b, bvh, sun_direction,
                           sun_radiance, sky_ambient * 0.5)
    rad = torch.where(hit[..., None], rad, sky_ambient * cfg.sky_leak)
    dist_cap = spacing * 4.0
    cap = torch.full((), dist_cap, device=dev)
    d_ray = torch.where(hit, torch.clamp_max(t, dist_cap), cap)
    irr_new, dist_new = _convolve(rad, d_ray, dirs, cfg)

    w_old = state.weight[cascade, sl]
    h = torch.where(w_old > 0.0, cfg.hysteresis,
                    torch.zeros((), device=dev))[:, None, None]
    irr_b = state.irr[cascade, sl] * h + irr_new * (1.0 - h)
    dist_b = state.dist[cascade, sl] * h + dist_new * (1.0 - h)

    # relocation (ddgi_relocation.hlsl): the nearest hit, first on a tie
    t_masked = torch.where(hit, t, torch.full((), float("inf"), device=dev))
    j = torch.argmin(t_masked, dim=1)
    t_min = torch.gather(t_masked, 1, j[:, None])[:, 0]
    d_min = dirs[j]
    mf = cfg.min_frontface * spacing
    push = torch.where((t_min < mf)[:, None],
                       -d_min * (mf - torch.clamp_max(t_min, mf))[:, None],
                       torch.zeros((), device=dev))
    max_off = cfg.max_offset_frac * spacing
    new = DDGIState(*(x.clone() for x in state))
    for dst, v in zip(new, (irr_b, dist_b, _project_sh(irr_b, cfg),
                            torch.clamp(off + push, -max_off, max_off),
                            torch.clamp_max(w_old + 1.0, 64.0))):
        dst[cascade, sl] = v
    return new


# --- sampling ----------------------------------------------------------------

def _pick_cascade(pos: torch.Tensor, cfg: DDGIConfig) -> torch.Tensor:
    """The smallest cascade whose volume holds each point (...,3) ->
    (...,) i32."""
    dev = pos.device
    half0 = (const(tuple(float(x) for x in cfg.probe_dim), dev) * 0.5 -
             1.0) * cfg.base_spacing
    m = (torch.abs(pos) / half0).amax(-1)
    c = torch.ceil(torch.log2(torch.clamp_min(m, 1.0)))
    return f2i(torch.clamp(c, 0, cfg.cascades - 1))


def sample_ddgi(state: DDGIState, pos_tw: torch.Tensor,
                normal: torch.Tensor, cfg: DDGIConfig, mode: str = "sh"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Irradiance at surface points (sampleDDGI, ddgi.h:197-311): the 8
    probes about the normal-biased point in its cascade, each weighted by
    trilinear x wrap shading x Chebyshev visibility (its distance texel
    toward the point) x traced. mode "sh": each probe's L1 SH at the
    normal; "oct": its nearest irradiance texel. -> (irradiance (...,3),
    confidence (...,))."""
    if mode not in ("sh", "oct"):
        raise ValueError(f"unknown DDGI sample mode {mode!r}")
    dev = pos_tw.device
    shape = pos_tw.shape[:-1]
    pos = pos_tw.reshape(-1, 3)
    nrm = normal.reshape(-1, 3)
    n = pos.shape[0]
    p = probe_count(cfg)
    dx, dy, dz = cfg.probe_dim
    c = _pick_cascade(pos, cfg)
    spacing = (cfg.base_spacing * torch.exp2(c.float()))[:, None]
    pb = pos + nrm * (cfg.normal_bias * spacing)
    dims = const((float(dx), float(dy), float(dz)), dev)
    g = pb / spacing + (dims - 1.0) * 0.5
    gi = f2i(torch.floor(g))
    i0 = torch.stack([torch.clamp(gi[:, a], 0, n - 2)
                      for a, n in enumerate(cfg.probe_dim)], -1)
    fr = torch.clamp(g - i0.float(), 0.0, 1.0)
    sh_t = state.sh.reshape(-1, 12)
    irr_t = state.irr.reshape(-1, cfg.irr_side ** 2, 3)
    dist_t = state.dist.reshape(-1, cfg.dist_side ** 2, 2)
    off_t = state.offset.reshape(-1, 3)
    w_t = state.weight.reshape(-1)
    irr_sum = torch.zeros((n, 3), device=dev)
    w_sum = torch.zeros((n,), device=dev)
    tri_sum = torch.zeros((n,), device=dev)
    y_n = torch.stack([torch.full((n,), SH0, device=dev), SH1 * nrm[:, 1],
                       SH1 * nrm[:, 2], SH1 * nrm[:, 0]], -1)   # (N,4)
    oct_n = octahedral_texel_index(nrm, cfg.irr_side).long()
    for corner in range(8):
        d = ((corner >> 2) & 1, (corner >> 1) & 1, corner & 1)
        cell = torch.stack([i0[:, a] + d[a] for a in range(3)], -1)
        idx = (c * p + (cell[:, 0] * dy + cell[:, 1]) * dz +
               cell[:, 2]).long()
        f = [fr[:, a] if d[a] else 1.0 - fr[:, a] for a in range(3)]
        tri = f[0] * f[1] * f[2]
        # wrap shading: probes behind the surface count less (ddgi.h:248)
        probe_pos = (cell.float() - (dims - 1.0) * 0.5) * spacing + off_t[idx]
        to_probe = probe_pos - pos
        # XLA's order: the distance and the dot feed the texel choice and
        # the Chebyshev test
        dist_tp = norm3(to_probe)
        dir_tp = to_probe / torch.clamp_min(dist_tp[:, None], 1e-6)
        wrap = (dot3(dir_tp, nrm) * 0.5 + 0.5) ** 2 + 0.05
        # Chebyshev visibility from the distance texels (ddgi.h:248-270)
        oct_d = octahedral_texel_index(-dir_tp, cfg.dist_side).long()
        mm = dist_t[idx, oct_d]
        mean, mean2 = mm[:, 0], mm[:, 1]
        var = torch.clamp_min(mean2 - mean * mean, 1e-4)
        delta = torch.clamp_min(dist_tp - mean, 0.0)
        cheb = var / (var + delta * delta)
        vis = torch.where(dist_tp > mean, torch.clamp_min(cheb ** 3, 0.05),
                          torch.ones((), device=dev))
        traced = (w_t[idx] > 0.0).float()
        w = tri * wrap * vis * traced
        if mode == "sh":
            e = torch.clamp_min(torch.einsum(
                "nk,nkc->nc", y_n, sh_t[idx].reshape(n, 4, 3)), 0.0)
        else:
            e = irr_t[idx, oct_n]
        irr_sum = irr_sum + e * w[:, None]
        w_sum = w_sum + w
        tri_sum = tri_sum + tri * traced
    irr = irr_sum / torch.clamp_min(w_sum, 1e-4)[:, None]
    conf = torch.clamp(tri_sum, 0.0, 1.0) * (w_sum > 1e-3).float()
    return irr.reshape(shape + (3,)) * cfg.intensity, conf.reshape(shape)


def diffuse_ddgi(state: DDGIState, gbuf, cfg: DDGIConfig,
                 mode: str = "sh") -> torch.Tensor:
    """-> (H,W,3) indirect diffuse irradiance (before albedo), sampled at
    1/sample_div res and nearest-upsampled (as gi.diffuse_gi)."""
    k = cfg.sample_div
    irr_q, conf_q = sample_ddgi(state, gbuf.position_tw[::k, ::k],
                                gbuf.normal[::k, ::k], cfg, mode=mode)
    h, w = gbuf.valid.shape
    irr = upsample_nearest(irr_q * conf_q[..., None], k, h, w)
    return torch.where(gbuf.valid[..., None], irr,
                       torch.zeros((), device=irr.device))
