"""Split-sum environment BRDF LUT (port of chord_tpu/ops/brdf_lut.py;
reference renderer/lut/brdf_lut.cpp + shader/brdf_lut.hlsl).

(A, B) over (NoV, roughness) by Monte-Carlo GGX importance sampling, built
once by the host-side runner; ambient / GI specular is F = f0 * A + B. The
frame itself uses `env_specular_analytic` (Lazarov's fit), as chord_tpu's
does; the LUT rides on the view for `env_specular`. chord_tpu's
`lax.scan` over the samples is a loop here, in the same summation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._util import const, f2i
from ..utils.device import resolve

LUT_SIZE = 32


def _hammersley(n: int) -> np.ndarray:
    """(n,2) low-discrepancy set (van der Corput base 2)."""
    i = np.arange(n)
    bits = i.copy()
    r = np.zeros(n)
    f = 0.5
    for _ in range(16):
        r += (bits & 1) * f
        bits >>= 1
        f *= 0.5
    return np.stack([i / n, r], -1)


def build_env_brdf_lut(samples: int = 256, device=None) -> torch.Tensor:
    """-> (LUT_SIZE, LUT_SIZE, 2) f32 (A, B) indexed by (NoV, roughness),
    on `device` (None = the card)."""
    device = resolve(device)
    f32 = dict(dtype=torch.float32, device=device)
    xi = torch.as_tensor(np.asarray(_hammersley(samples), np.float32),
                         device=device)
    nov = (torch.arange(LUT_SIZE, **f32) + 0.5) / LUT_SIZE
    rough = (torch.arange(LUT_SIZE, **f32) + 0.5) / LUT_SIZE
    nov_g, r_g = torch.meshgrid(nov, rough, indexing="ij")
    a = torch.clamp_min(r_g * r_g, 1e-3)
    v = torch.stack([torch.sqrt(1 - nov_g ** 2), torch.zeros_like(nov_g),
                     nov_g], -1)
    # Schlick-GGX Smith visibility with the IBL k = alpha/2 convention
    k = a / 2.0
    g_v = nov_g / (nov_g * (1 - k) + k)
    A = torch.zeros_like(nov_g)
    B = torch.zeros_like(nov_g)
    for i in range(samples):
        e1, e2 = xi[i, 0], xi[i, 1]
        phi = 2 * math.pi * e1
        ct = torch.sqrt((1 - e2) / (1 + (a ** 2 - 1) * e2))
        st = torch.sqrt(torch.clamp_min(1 - ct * ct, 0.0))
        h = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
        voh = (v * h).sum(-1)
        l_ = 2 * voh[..., None] * h - v
        nol = torch.clamp(l_[..., 2], 0.0, 1.0)
        noh = torch.clamp(ct, 0.0, 1.0)
        vohc = torch.clamp(voh, 0.0, 1.0)
        g_l = nol / (nol * (1 - k) + k)
        g = g_v * g_l
        g_vis = torch.where(nol > 0,
                            g * vohc / torch.clamp_min(noh * nov_g, 1e-6),
                            torch.zeros((), **f32))
        fc = (1 - vohc) ** 5
        A = A + (1 - fc) * g_vis
        B = B + fc * g_vis
    A = A / samples
    B = B / samples
    # energy conservation: clamp A + B to 1 (the excess at grazing NoV is
    # 1/NoV estimator noise)
    scale = torch.clamp_max(1.0 / torch.clamp_min(A + B, 1e-6), 1.0)
    return torch.stack([A * scale, B * scale], -1)


def env_specular(lut: torch.Tensor, f0: torch.Tensor, roughness: torch.Tensor,
                 nov: torch.Tensor) -> torch.Tensor:
    """Split-sum env term f0 * A + B from the LUT (nearest texel)."""
    xi = torch.clamp(f2i(nov * LUT_SIZE), 0, LUT_SIZE - 1).long()
    yi = torch.clamp(f2i(roughness * LUT_SIZE), 0, LUT_SIZE - 1).long()
    ab = lut[xi, yi]
    return f0 * ab[..., 0:1] + ab[..., 1:2]


def env_specular_analytic(f0: torch.Tensor, roughness: torch.Tensor,
                          nov: torch.Tensor) -> torch.Tensor:
    """Gather-free split-sum env term: Lazarov's analytic fit of the
    GGX + Smith environment BRDF."""
    dev = roughness.device
    c0 = const((-1.0, -0.0275, -0.572, 0.022), dev)
    c1 = const((1.0, 0.0425, 1.04, -0.04), dev)
    r = roughness[..., None] * c0 + c1
    a004 = (torch.minimum(r[..., 0] * r[..., 0], torch.exp2(-9.28 * nov)) *
            r[..., 0] + r[..., 1])
    a_ = (-1.04 * a004 + r[..., 2])[..., None]
    b_ = (1.04 * a004 + r[..., 3])[..., None]
    return f0 * a_ + b_
