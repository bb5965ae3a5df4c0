"""Wide-gamut ACEScg colour pipeline (port of chord_tpu/ops/colorspace.py;
reference colorspace.h:9-112, tonemapping.hlsl:34-136).

All lighting happens in linear ACEScg (AP1). Colours are (..., 3) tensors
and matrices apply as `c @ M` (row-vector convention). The matrices are
chord_tpu's constants.
"""

from __future__ import annotations

import numpy as np
import torch

SRGB_TO_AP1 = np.array([
    [0.61309732, 0.07019422, 0.02061560],
    [0.33952285, 0.91635557, 0.10956983],
    [0.04737928, 0.01345021, 0.86981512],
], dtype=np.float32)

AP1_TO_SRGB = np.array([
    [1.70505099, -0.13025642, -0.02400336],
    [-0.62179212, 1.14080474, -0.12896898],
    [-0.08325883, -0.01054832, 1.15297234],
], dtype=np.float32)

AP1_LUMA = np.array([0.2722287168, 0.6740817658, 0.0536895174], np.float32)

_RRT_SAT = 0.96


def _mat3(c: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    return c @ torch.as_tensor(m, device=c.device)


def srgb_to_acescg(c: torch.Tensor) -> torch.Tensor:
    """Linear sRGB -> linear ACEScg (AP1)."""
    return _mat3(c, SRGB_TO_AP1)


def acescg_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Linear ACEScg (AP1) -> linear sRGB."""
    return _mat3(c, AP1_TO_SRGB)


def luminance_ap1(c: torch.Tensor) -> torch.Tensor:
    """AP1 relative luminance -> (...,)."""
    return c @ torch.as_tensor(AP1_LUMA, device=c.device)


def srgb_eotf_inv(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB-encoded (the OETF applied before 8-bit quantize)."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-7), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def aces_film_ap1(c: torch.Tensor) -> torch.Tensor:
    """AP1 linear HDR -> AP1 [0,1] display-linear via the fitted RRT+ODT
    rational curve, with the RRT global desaturation."""
    luma = luminance_ap1(c)[..., None]
    c = luma + _RRT_SAT * (c - luma)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return torch.clamp(a / b, 0.0, 1.0)


def tonemap_display(hdr_ap1: torch.Tensor, exposure: torch.Tensor,
                    output: str = "srgb8") -> torch.Tensor:
    """exposure -> film curve (AP1) -> sRGB-encoded floats in [0,1]."""
    if output != "srgb8":
        raise NotImplementedError(
            f"RendererConfig.output={output!r}: only 'srgb8' is ported")
    filmic = aces_film_ap1(hdr_ap1 * exposure)
    return srgb_eotf_inv(torch.clamp(acescg_to_srgb(filmic), 0.0, 1.0))


def to_u8(encoded: torch.Tensor) -> torch.Tensor:
    """Encoded [0,1] floats -> uint8 with rounding."""
    return torch.clamp(encoded * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
