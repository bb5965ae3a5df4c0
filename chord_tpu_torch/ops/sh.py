"""Real spherical harmonics, 3 bands (9 coefficients): the radiance
representation of the screen-probe GI and the world cache (port of
chord_tpu/ops/sh.py; reference shader/gi.h:21-29 SH3_gi).

A probe's SH is a plain (..., 9, 3) tensor; packed, (..., 28) = the 27
coefficients + the sample count. Basis (standard real SH):
  Y0  = 0.282095
  Y1  = 0.488603 * (y, z, x)
  Y2  = 1.092548*(xy, yz, xz), 0.315392*(3z^2-1), 0.546274*(x^2-y^2)
Cosine-lobe convolution for irradiance: A = (pi, 2pi/3, pi/4) per band.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ._util import const

NUM_COEFFS = 9

_C0 = 0.28209479177387814          # 1/(2 sqrt(pi))
_C1 = 0.4886025119029199           # sqrt(3)/(2 sqrt(pi))
_C2a = 1.0925484305920792          # sqrt(15)/(2 sqrt(pi))   (xy, yz, xz)
_C2b = 0.31539156525252005         # sqrt(5)/(4 sqrt(pi))    (3z^2 - 1)
_C2c = 0.5462742152960396          # sqrt(15)/(4 sqrt(pi))   (x^2 - y^2)

# clamped-cosine convolution per coefficient: E(n) = sum_i A_i L_i Y_i(n)
A_BAND = np.array([np.pi,
                   2.0 * np.pi / 3.0, 2.0 * np.pi / 3.0, 2.0 * np.pi / 3.0,
                   np.pi / 4.0, np.pi / 4.0, np.pi / 4.0, np.pi / 4.0,
                   np.pi / 4.0], np.float32)


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """Unit directions (..., 3) -> SH basis values (..., 9)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        torch.full_like(x, _C0),
        _C1 * y,
        _C1 * z,
        _C1 * x,
        _C2a * x * y,
        _C2a * y * z,
        _C2b * (3.0 * z * z - 1.0),
        _C2a * x * z,
        _C2c * (x * x - y * y),
    ], dim=-1)


def project(radiance: torch.Tensor, dirs: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Monte-Carlo projection of radiance samples onto SH3.

    radiance (..., N, 3), dirs (..., N, 3) unit, weights (..., N) optional
    -> (..., 9, 3): L_i = (4 pi / N_eff) sum_k w_k radiance_k Y_i(d_k)."""
    y = sh_basis(dirs)                                    # (..., N, 9)
    if weights is not None:
        y = y * weights[..., None]
        n_eff = torch.clamp_min(weights.sum(-1), 1e-6)[..., None, None]
    else:
        n_eff = float(dirs.shape[-2])
    coeffs = torch.einsum("...nc,...nk->...kc", radiance, y)
    return coeffs * (4.0 * math.pi) / n_eff


def eval_radiance(sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """SH (..., 9, 3) evaluated along unit directions (..., 3) -> (..., 3)."""
    return torch.einsum("...kc,...k->...c", sh, sh_basis(d))


def eval_irradiance(sh: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Cosine-convolved irradiance (..., 3) at normals (..., 3); divide by
    pi for Lambertian exit radiance at the caller."""
    a = const(tuple(A_BAND.tolist()), sh.device)
    return torch.einsum("...kc,...k->...c", sh, sh_basis(n) * a)


def pack(sh: torch.Tensor, num_sample: torch.Tensor) -> torch.Tensor:
    """(..., 9, 3) + (...,) -> (..., 28): 27 coefficients + numSample."""
    flat = sh.reshape(sh.shape[:-2] + (27,))
    return torch.cat([flat, num_sample[..., None]], dim=-1)


def unpack(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 28) -> ((..., 9, 3), (...,))."""
    sh = packed[..., :27].reshape(packed.shape[:-1] + (9, 3))
    return sh, packed[..., 27]
