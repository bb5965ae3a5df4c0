"""Physically based sky and aerial perspective with precomputed LUTs (port of
chord_tpu/ops/atmosphere.py; reference manager_atmosphere.cpp:607-641,
lighting.hlsl:75-135).

Hillaire 2020: Rayleigh + Mie + ozone with multiple scattering, in two small
sun-independent LUTs (transmittance 64x256, multiscatter 32x32) and a
sun-dependent sky-view LUT (104x200), all built once by the host-side
runner and carried on the view. The LUT builders' `fori_loop`/`scan` are
plain loops here. Distances in km; radiance in linear sRGB primaries
(callers convert to AP1).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ._util import (centres, const, dot3, f2i, host_table, norm3,
                    sincosf_plain)


class AtmosphereParams(NamedTuple):
    """Earth-like defaults (chord_tpu AtmosphereParams)."""

    ground_radius_km: float = 6360.0
    top_radius_km: float = 6460.0
    rayleigh_scatter: Tuple[float, float, float] = (5.802e-3, 13.558e-3,
                                                    33.1e-3)
    rayleigh_scale_h: float = 8.0
    mie_scatter: float = 3.996e-3
    mie_absorb: float = 4.4e-3
    mie_scale_h: float = 1.2
    mie_g: float = 0.8
    ozone_absorb: Tuple[float, float, float] = (0.650e-3, 1.881e-3, 0.085e-3)
    ozone_center_km: float = 25.0
    ozone_width_km: float = 30.0
    ground_albedo: float = 0.3
    sun_illuminance: float = 20.0       # arbitrary HDR scale
    km_per_unit: float = 0.05           # world unit -> km for aerial


TRANSMITTANCE_W, TRANSMITTANCE_H = 256, 64
MS_SIZE = 32
SKYVIEW_W, SKYVIEW_H = 200, 104


def _densities(p: AtmosphereParams, h: torch.Tensor):
    """altitude above ground (km) -> (rayleigh, mie, ozone) densities."""
    ray = torch.exp(-h / p.rayleigh_scale_h)
    mie = torch.exp(-h / p.mie_scale_h)
    ozo = torch.clamp(1.0 - torch.abs(h - p.ozone_center_km) /
                      (p.ozone_width_km * 0.5), 0.0, 1.0)
    return ray, mie, ozo


def _extinction(p: AtmosphereParams, h: torch.Tensor) -> torch.Tensor:
    """(...,) altitude -> (...,3) extinction coefficient."""
    ray, mie, ozo = _densities(p, h)
    return (ray[..., None] * const(p.rayleigh_scatter, h.device) +
            (mie * (p.mie_scatter + p.mie_absorb))[..., None] +
            ozo[..., None] * const(p.ozone_absorb, h.device))


def _ray_sphere(r0: torch.Tensor, mu: torch.Tensor, radius: float
                ) -> torch.Tensor:
    """Distance along a ray from radius r0 with cos-zenith mu to the sphere
    `radius`; -1 if no hit in front."""
    b = 2.0 * r0 * mu
    c = r0 * r0 - radius * radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b - sq) * 0.5
    t1 = (-b + sq) * 0.5
    t = torch.where(t0 >= 0.0, t0, t1)
    return torch.where((disc < 0.0) | (t < 0.0), torch.full_like(t, -1.0), t)


def _atmo_distance(p: AtmosphereParams, r: torch.Tensor, mu: torch.Tensor
                   ) -> torch.Tensor:
    """Ray length through the atmosphere (stops at the ground)."""
    t_top = _ray_sphere(r, mu, p.top_radius_km)
    t_gnd = _ray_sphere(r, mu, p.ground_radius_km)
    return torch.where(t_gnd > 0.0, t_gnd, torch.clamp_min(t_top, 0.0))


# --- transmittance LUT: u = cos zenith in [-1,1], v = altitude ----------------

def build_transmittance_lut(p: AtmosphereParams, steps: int = 40,
                            device=None) -> torch.Tensor:
    """(64,256,3) transmittance from altitude v toward cos-zenith u to the
    top of the atmosphere."""
    from ..utils.device import resolve

    dev = resolve(device)
    h_atm = p.top_radius_km - p.ground_radius_km
    alt = centres(TRANSMITTANCE_H, dev) * h_atm
    mu = centres(TRANSMITTANCE_W, dev) * 2.0 - 1.0
    r = alt[:, None] + p.ground_radius_km                       # (H,1)
    mu2 = mu[None, :]                                           # (1,W)
    dt = _atmo_distance(p, r, mu2) / steps                      # (H,W)
    od = torch.zeros((TRANSMITTANCE_H, TRANSMITTANCE_W, 3), device=dev)
    for i in range(steps):
        t = (i + 0.5) * dt
        rt = torch.sqrt(r * r + t * t + 2.0 * r * t * mu2)
        h = torch.clamp(rt - p.ground_radius_km, 0.0, h_atm)
        od = od + _extinction(p, h) * dt[..., None]
    return torch.exp(-od)


def sample_transmittance(lut: torch.Tensor, p: AtmosphereParams,
                         r: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the transmittance LUT at (radius r, cos mu)."""
    h_atm = p.top_radius_km - p.ground_radius_km
    v = torch.clamp((r - p.ground_radius_km) / h_atm, 0.0, 1.0)
    u = torch.clamp(mu * 0.5 + 0.5, 0.0, 1.0)
    return _bilinear(lut, u * (TRANSMITTANCE_W - 1),
                     v * (TRANSMITTANCE_H - 1))


def _bilinear(lut: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """lut (H,W,C) at non-negative texel coordinates x, y (broadcast)."""
    x, y = torch.broadcast_tensors(x, y)
    hl, wl = lut.shape[:2]
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = f2i(x0f).long(), f2i(y0f).long()
    x1 = torch.clamp(x0 + 1, max=wl - 1)
    y1 = torch.clamp(y0 + 1, max=hl - 1)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    return (lut[y0, x0] * (1 - fx) * (1 - fy) + lut[y0, x1] * fx * (1 - fy) +
            lut[y1, x0] * (1 - fx) * fy + lut[y1, x1] * fx * fy)


# --- multiple-scattering LUT ---------------------------------------------------

def build_multiscatter_lut(p: AtmosphereParams, t_lut: torch.Tensor,
                           dir_samples: int = 64, steps: int = 20
                           ) -> torch.Tensor:
    """(32,32,3) isotropic multiple-scattering transfer Psi_ms (Hillaire
    eq. 5-7) over Fibonacci-sphere directions."""
    dev = t_lut.device
    h_atm = p.top_radius_km - p.ground_radius_km
    sun_mu = centres(MS_SIZE, dev) * 2.0 - 1.0                 # (S,)
    r = (centres(MS_SIZE, dev) * h_atm)[:, None] + p.ground_radius_km
    rs = const(p.rayleigh_scatter, t_lut.device)

    k = np.arange(dir_samples) + 0.5
    phi = np.pi * (1 + 5 ** 0.5) * k
    cz = 1 - 2 * k / dir_samples
    sz = np.sqrt(1 - cz ** 2)
    dirs = torch.tensor(np.stack([sz * np.cos(phi), sz * np.sin(phi), cz],
                                 -1), dtype=torch.float32, device=dev)

    zero = torch.zeros((MS_SIZE, MS_SIZE, 3), device=dev)
    l_2nd, f_ms = zero, zero
    t_sun_g = sample_transmittance(t_lut, p, torch.full_like(
        r, p.ground_radius_km), sun_mu[None, :])
    nol = torch.clamp_min(sun_mu[None, :, None], 0.0)
    for d in dirs:
        mu = d[2]                                   # view cos zenith
        dt = _atmo_distance(p, r, mu) / steps       # (S,1)
        l2, fm = zero, zero
        throughput = torch.ones((MS_SIZE, 1, 3), device=dev)
        for i in range(steps):
            t = (i + 0.5) * dt
            rt = torch.sqrt(r * r + t * t + 2.0 * r * t * mu)
            h = torch.clamp(rt - p.ground_radius_km, 0.0, h_atm)
            ray, mie, _ = _densities(p, h)
            scat = ray[..., None] * rs + (mie * p.mie_scatter)[..., None]
            ext = _extinction(p, h)
            step_t = torch.exp(-ext * dt[..., None])
            # flat-sun approximation: the sun's cos zenith is sun_mu
            t_sun = sample_transmittance(t_lut, p, rt, sun_mu[None, :])
            integ = scat * (1.0 - step_t) / torch.clamp_min(ext, 1e-9)
            l2 = l2 + throughput * integ * t_sun / (4.0 * np.pi)
            fm = fm + throughput * integ / (4.0 * np.pi)
            throughput = throughput * step_t
        # ground bounce for downward rays
        hits_gnd = _ray_sphere(r, mu, p.ground_radius_km) > 0.0
        l2 = l2 + torch.where(hits_gnd[..., None], throughput * t_sun_g *
                              nol * p.ground_albedo / np.pi, zero)
        l_2nd = l_2nd + l2
        f_ms = f_ms + fm
    l_2nd = l_2nd / dir_samples
    f_ms = f_ms / dir_samples
    return l_2nd / torch.clamp_min(1.0 - f_ms, 1e-4)


# --- sky-view LUT (per sun direction) -------------------------------------------

def _phase_rayleigh(c):
    return 3.0 / (16.0 * np.pi) * (1.0 + c * c)


def _phase_mie(c, g):
    g2 = g * g
    num = 3.0 * (1.0 - g2) * (1.0 + c * c)
    den = 8.0 * np.pi * (2.0 + g2) * torch.pow(1.0 + g2 - 2.0 * g * c, 1.5)
    return num / torch.clamp_min(den, 1e-9)


def raymarch_scattering(p: AtmosphereParams, t_lut: torch.Tensor,
                        ms_lut: torch.Tensor, r0: torch.Tensor,
                        view_mu: torch.Tensor, sun_mu: torch.Tensor,
                        cos_sun_view: torch.Tensor, steps: int = 24
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-scattering ray march + the multiple-scattering term ->
    (radiance (...,3), transmittance (...,3))."""
    h_atm = p.top_radius_km - p.ground_radius_km
    rs = const(p.rayleigh_scatter, t_lut.device)
    dt = _atmo_distance(p, r0, view_mu) / steps
    ph_r = _phase_rayleigh(cos_sun_view)
    ph_m = _phase_mie(cos_sun_view, p.mie_g)
    shape = torch.broadcast_shapes(r0.shape, view_mu.shape, sun_mu.shape)
    lum = torch.zeros(shape + (3,), device=t_lut.device)
    throughput = torch.ones_like(lum)
    for i in range(steps):
        t = (i + 0.5) * dt
        rt = torch.sqrt(r0 * r0 + t * t + 2.0 * r0 * t * view_mu)
        h = torch.clamp(rt - p.ground_radius_km, 0.0, h_atm)
        ray, mie, _ = _densities(p, h)
        scat_r = ray[..., None] * rs
        scat_m = (mie * p.mie_scatter)[..., None]
        ext = _extinction(p, h)
        step_t = torch.exp(-ext * dt[..., None])
        t_sun = sample_transmittance(t_lut, p, rt, sun_mu)
        msv = torch.clamp(h / h_atm, 0.0, 1.0)
        msu = torch.clamp(sun_mu * 0.5 + 0.5, 0.0, 1.0)
        mx = torch.clamp(f2i(msu * (MS_SIZE - 1)), 0, MS_SIZE - 1).long()
        my = torch.clamp(f2i(msv * (MS_SIZE - 1)), 0, MS_SIZE - 1).long()
        psi = ms_lut[my, mx]
        in_scatter = ((scat_r * ph_r[..., None] + scat_m * ph_m[..., None]) *
                      t_sun + (scat_r + scat_m) * psi)
        integ = in_scatter * (1.0 - step_t) / torch.clamp_min(ext, 1e-9)
        lum = lum + throughput * integ
        throughput = throughput * step_t
    return lum * p.sun_illuminance, throughput


def build_sky_view_lut(p: AtmosphereParams, t_lut: torch.Tensor,
                       ms_lut: torch.Tensor, sun_dir: torch.Tensor,
                       cam_alt_km: float = 0.2) -> torch.Tensor:
    """(104,200,3) sky radiance: longitude x non-linear latitude (more rows
    at the horizon)."""
    dev = t_lut.device
    r0 = torch.full((), cam_alt_km + p.ground_radius_km, device=dev)
    sin_lat, cos_lat, sin_lon, cos_lon = (
        host_table(t.numpy(), dev) for t in _sky_view_trig())
    shape = (SKYVIEW_H, SKYVIEW_W)
    mu = sin_lat[:, None] * torch.ones((1, SKYVIEW_W), device=dev)
    cl = cos_lat[:, None]
    view = torch.stack([cl * cos_lon[None, :], sin_lat[:, None].expand(shape),
                        cl * sin_lon[None, :]], -1)
    cos_sv = dot3(view, sun_dir)
    lum, _ = raymarch_scattering(p, t_lut, ms_lut, r0.expand(shape), mu,
                                 sun_dir[1].expand(shape), cos_sv)
    return lum


def _sky_view_trig():
    """-> sin and cos of the sky-view LUT's latitudes (rows; non-linear,
    more rows at the horizon, in [-pi/2, pi/2]) and of its longitudes
    (columns), f32 on the host: the angles depend only on the grid, and
    sincosf_plain takes them as chord_tpu's XLA does."""
    cpu = torch.device("cpu")
    v = centres(SKYVIEW_H, cpu)
    u = centres(SKYVIEW_W, cpu)
    lat = torch.where(v < 0.5, -(0.5 - v) ** 2 * 2.0 * np.pi * 0.5,
                      (v - 0.5) ** 2 * 2.0 * np.pi * 0.5)
    lon = u * 2.0 * np.pi
    return (*sincosf_plain(lat), *sincosf_plain(lon))


def sample_sky(lut: torch.Tensor, view_dir: torch.Tensor) -> torch.Tensor:
    """Sky-view LUT at (...,3) world directions -> (...,3)."""
    d = view_dir / torch.clamp_min(norm3(view_dir, keepdim=True), 1e-8)
    lat = torch.arcsin(torch.clamp(d[..., 1], -1.0, 1.0))
    lon = torch.remainder(torch.atan2(d[..., 2], d[..., 0]), 2.0 * np.pi)
    v = torch.where(lat < 0.0, 0.5 - torch.sqrt(-lat / np.pi),
                    0.5 + torch.sqrt(lat / np.pi))
    u = lon / (2.0 * np.pi)
    x = torch.clamp(u * SKYVIEW_W - 0.5, 0.0, SKYVIEW_W - 1)
    y = torch.clamp(v * SKYVIEW_H - 0.5, 0.0, SKYVIEW_H - 1)
    return _bilinear(lut, x, y)


def sun_disk_radiance(p: AtmosphereParams, t_lut: torch.Tensor,
                      view_dir: torch.Tensor, sun_dir: torch.Tensor,
                      cam_alt_km: float = 0.2,
                      sun_angular_radius: float = 0.00465) -> torch.Tensor:
    """Sun disk with limb transmittance, added to sky pixels: one
    transmittance sample at the sun's elevation for the whole disk."""
    r0 = torch.full((), cam_alt_km + p.ground_radius_km, device=t_lut.device)
    in_disk = (dot3(view_dir, sun_dir) >= math.cos(sun_angular_radius)
               )[..., None]
    t_sun = sample_transmittance(t_lut, p, r0, sun_dir[1])
    return torch.where(in_disk, t_sun * p.sun_illuminance * 50.0,
                       torch.zeros((), device=t_lut.device))


def sky_ambient_irradiance(lut: torch.Tensor) -> torch.Tensor:
    """Hemispheric mean of the sky-view LUT's upper half -> (3,)."""
    return lut[SKYVIEW_H // 2:].mean(dim=(0, 1))


def aerial_perspective(p: AtmosphereParams, dist_units: torch.Tensor,
                       sky_along_view: torch.Tensor, cam_alt_km=0.2,
                       view_dir_y=None):
    """Aerial perspective on geometry: closed-form slant-path optical depth
    for the exponential Rayleigh and Mie profiles (ozone at the path's mean
    altitude), in-scatter = sky along the view * (1 - T).
    dist_units (...,) camera distance in world units; cam_alt_km scalar or
    () tensor; view_dir_y (...,) unit view-direction y (None = level).
    -> (transmittance (...,3), in_scatter (...,3))."""
    dev = dist_units.device
    h_top = p.top_radius_km - p.ground_radius_km
    d_km = dist_units * p.km_per_unit
    h0 = torch.clamp(torch.as_tensor(cam_alt_km, dtype=torch.float32,
                                     device=dev), 0.0, h_top)
    if view_dir_y is None:
        t = torch.exp(-_extinction(p, h0) * d_km[..., None])
        return t, sky_along_view * (1.0 - t)

    dy = view_dir_y
    h_end = torch.clamp(h0 + d_km * dy, 0.0, h_top)

    def tau_exp(sigma, scale_h):
        """Closed-form optical depth for density exp(-h/H)."""
        flatish = torch.abs(dy) < 1e-3
        safe_dy = torch.where(flatish, torch.ones_like(dy), dy)
        slant = ((scale_h / safe_dy) * torch.exp(-h0 / scale_h) *
                 (1.0 - torch.exp(-d_km * dy / scale_h)))
        level = d_km * torch.exp(-h0 / scale_h)
        return sigma * torch.where(flatish, level, slant)[..., None]

    tau = tau_exp(const(p.rayleigh_scatter, d_km.device), p.rayleigh_scale_h)
    tau = tau + tau_exp(const(p.mie_scatter + p.mie_absorb, d_km.device),
                        p.mie_scale_h)
    h_mid = 0.5 * (h0 + h_end)
    ozo = torch.clamp(1.0 - torch.abs(h_mid - p.ozone_center_km) /
                      (p.ozone_width_km * 0.5), 0.0, 1.0)
    tau = tau + (ozo * d_km)[..., None] * const(p.ozone_absorb, d_km.device)
    t = torch.exp(-tau)
    return t, sky_along_view * (1.0 - t)
