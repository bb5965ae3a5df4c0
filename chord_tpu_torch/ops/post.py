"""Post-processing chain: auto-exposure, bloom, TSR (port of
chord_tpu/ops/post.py; reference histogram.hlsl, auto_exposure.hlsl,
bloom.cpp, tsr_*.hlsl).

TSR in chord_tpu's three modes, at render size (`temporal_resolve`) or
with the render->post upscale (`temporal_upscale`): `gather` fetches each
pixel's history bilinearly from a bf16 copy at its previous position;
`global` shifts the whole history by the mean screen motion and blends on
the per-pixel residual; `tile` reprojects the history per 32x128 tile
through kernel K4 (ops/tile_reproject.py), the bench's mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import colorspace
from ._util import f2i

HISTOGRAM_BINS = 128   # reference shader/base.h:426 kHistogramBinCount


# --- resampling helpers ------------------------------------------------------

def decimate(x: torch.Tensor, k) -> torch.Tensor:
    """Nearest k-fold downsample over the leading two axes: x[::ky, ::kx]
    (chord_tpu's one-hot-matmul form equals this for finite inputs)."""
    ky, kx = (k, k) if isinstance(k, int) else k
    return x[::ky, ::kx]


def upsample_nearest(x: torch.Tensor, k, out_h: int, out_w: int
                     ) -> torch.Tensor:
    """k-x nearest upsample of (h,w[,c]) cropped to (out_h, out_w); edge
    extended if the caller asks for more than h*k."""
    kh, kw = (k, k) if isinstance(k, int) else k
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    h, w, c = x.shape
    x = x[:, None, :, None, :].expand(h, kh, w, kw, c).reshape(h * kh,
                                                               w * kw, c)
    if out_h > h * kh or out_w > w * kw:
        x = F.pad(x.permute(2, 0, 1)[None].float(),
                  (0, max(0, out_w - w * kw), 0, max(0, out_h - h * kh)),
                  mode="replicate")[0].permute(1, 2, 0).to(x.dtype)
    x = x[:out_h, :out_w]
    return x[..., 0] if squeeze else x


def upsample2x_linear(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel-centre 2x bilinear upsample of (h,w[,c]) by shift and
    lerp: output row y samples v = (y+0.5)/2 - 0.5, so even rows blend
    rows (k-1, k) by (0.25, 0.75) and odd rows (k, k+1) by (0.75, 0.25);
    the same in x; edges clamp."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]

    def axis_up(a, axis):
        first, last = a.narrow(axis, 0, 1), a.narrow(axis, a.shape[axis] - 1, 1)
        prev = torch.cat([first, a.narrow(axis, 0, a.shape[axis] - 1)], axis)
        nxt = torch.cat([a.narrow(axis, 1, a.shape[axis] - 1), last], axis)
        even = 0.25 * prev + 0.75 * a
        odd = 0.75 * a + 0.25 * nxt
        sh = list(a.shape)
        sh[axis] *= 2
        return torch.stack([even, odd], dim=axis + 1).reshape(sh)

    x = axis_up(axis_up(x, 0), 1)
    return x[..., 0] if squeeze else x


def upsample_linear(x: torch.Tensor, k: int, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Power-of-two k-x bilinear upsample by repeated 2x steps, cropped to
    (out_h, out_w) (chord_tpu post.py:277; not equal to one k-x resize)."""
    if k & (k - 1):
        raise ValueError(f"k={k} must be a power of two")
    while k > 1:
        x = upsample2x_linear(x)
        k //= 2
    return x[:out_h, :out_w]


def _roll(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, shifts=(dy, dx), dims=(0, 1))


# --- auto exposure -------------------------------------------------------------

class ExposureConfig(NamedTuple):
    """reference: render_helper.h:516-526 PostprocessConfig."""

    min_log_lum: float = -10.0
    max_log_lum: float = 6.0
    low_percent: float = 0.5
    high_percent: float = 0.95
    speed_up: float = 3.0
    speed_down: float = 1.0
    exposure_compensation: float = 1.0
    fix_exposure: float = -1.0      # > 0 -> bypass


def luminance_histogram(color_ap1: torch.Tensor, cfg: ExposureConfig
                        ) -> torch.Tensor:
    """(H,W,3) AP1 -> (BINS,) normalized histogram of log2 luminance over
    1/4-res samples; bin 0 collects near-black pixels."""
    luma = colorspace.luminance_ap1(color_ap1[::4, ::4])
    scale = 1.0 / (cfg.max_log_lum - cfg.min_log_lum)
    t = (torch.log2(torch.clamp_min(luma, 1e-10)) - cfg.min_log_lum) * scale
    binf = torch.where(luma < 1e-5, torch.zeros((), device=luma.device),
                       1.0 + t * (HISTOGRAM_BINS - 2))
    bins = torch.clamp(f2i(binf), 0, HISTOGRAM_BINS - 1)
    hist = torch.bincount(bins.reshape(-1).long(),
                          minlength=HISTOGRAM_BINS).to(torch.float32)
    return hist / torch.clamp_min(hist.sum(), 1.0)


def adapt_exposure(hist: torch.Tensor, prev_exposure: torch.Tensor,
                   dt: float, cfg: ExposureConfig) -> torch.Tensor:
    """-> new adapted exposure (percentile-clipped mean luminance, key
    1.03 - 2/(2+log2(avg+1)), exponential up/down adaptation)."""
    if cfg.fix_exposure > 0.0:
        return torch.tensor(cfg.fix_exposure, dtype=torch.float32,
                            device=hist.device)
    dev = hist.device
    nonblack = hist.clone()
    nonblack[0] = 0.0
    nonblack = nonblack / torch.clamp_min(nonblack.sum(), 1e-6)
    cum = torch.cumsum(nonblack, 0)
    lo, hi = cfg.low_percent, cfg.high_percent
    prev_cum = torch.cat([torch.zeros(1, device=dev), cum[:-1]])
    band = torch.clamp(torch.clamp(cum, max=hi) - torch.clamp_min(prev_cum, lo),
                       0.0, 1.0)
    centers = ((torch.arange(HISTOGRAM_BINS, dtype=torch.float32, device=dev)
                - 1.0 + 0.5) / (HISTOGRAM_BINS - 2)
               * (cfg.max_log_lum - cfg.min_log_lum) + cfg.min_log_lum)
    band[0] = 0.0
    avg_log = (band * centers).sum() / torch.clamp_min(band.sum(), 1e-6)
    avg_lum = torch.exp2(avg_log)
    key = 1.03 - 2.0 / (2.0 + torch.log2(avg_lum + 1.0))
    target = key / torch.clamp_min(avg_lum, 1e-6) * cfg.exposure_compensation
    speed = torch.where(target > prev_exposure,
                        torch.tensor(cfg.speed_up, device=dev),
                        torch.tensor(cfg.speed_down, device=dev))
    blend = 1.0 - torch.exp(-dt * speed)
    return prev_exposure + (target - prev_exposure) * blend


# --- bloom ---------------------------------------------------------------------

class BloomConfig(NamedTuple):
    """reference: render_helper.h:527-536 + bloom.cpp:25-35."""

    threshold: float = 1.0
    soft_knee: float = 0.5
    intensity: float = 0.06
    radius: float = 0.75
    levels: int = 5


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x box downsample of (H,W,3); odd dims edge-padded to even."""
    h, w, _ = x.shape
    if h % 2 or w % 2:
        x = F.pad(x.permute(2, 0, 1)[None], (0, w % 2, 0, h % 2),
                  mode="replicate")[0].permute(1, 2, 0)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    return s * 0.25


def _upsample2(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """2x nearest upsample + separable [1,2,1]/4 tent (wrapping rolls)."""
    h, w, c = x.shape
    up = x[:, None, :, None, :].expand(h, 2, w, 2, c).reshape(2 * h, 2 * w, c)
    up = up[:out_h, :out_w]
    up = (torch.roll(up, 1, 0) * 0.25 + up * 0.5 +
          torch.roll(up, -1, 0) * 0.25)
    up = (torch.roll(up, 1, 1) * 0.25 + up * 0.5 +
          torch.roll(up, -1, 1) * 0.25)
    return up


def compute_bloom(color: torch.Tensor, cfg: BloomConfig) -> torch.Tensor:
    """(H,W,3) HDR AP1 -> bloom contribution (H,W,3): soft-knee threshold
    at half res, pyramid down, radius-weighted accumulate up."""
    full_h, full_w = color.shape[:2]
    color = _downsample2(color)
    luma = colorspace.luminance_ap1(color)[..., None]
    knee = cfg.threshold * cfg.soft_knee + 1e-5
    soft = torch.clamp(luma - cfg.threshold + knee, 0.0, 2.0 * knee)
    soft = soft * soft / (4.0 * knee)
    contrib = (torch.maximum(luma - cfg.threshold, soft) /
               torch.clamp_min(luma, 1e-5))
    mips = [color * contrib]
    for _ in range(cfg.levels):
        h, w, _ = mips[-1].shape
        if h < 8 or w < 8:
            break
        mips.append(_downsample2(mips[-1]))
    acc = mips[-1]
    for i in range(len(mips) - 2, -1, -1):
        h, w, _ = mips[i].shape
        acc = mips[i] + _upsample2(acc, h, w) * cfg.radius
    return _upsample2(acc * cfg.intensity, full_h, full_w)


# --- TSR ---------------------------------------------------------------------

def tsr_prepare(motion_ndc: torch.Tensor, depth: torch.Tensor
                ) -> torch.Tensor:
    """3x3 closest-depth motion dilation (reference tsr_prepare.hlsl)."""
    best_d = depth
    best_m = motion_ndc
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            d2 = _roll(depth, dy, dx)
            m2 = _roll(motion_ndc, dy, dx)
            best_m = torch.where((d2 > best_d)[..., None], m2, best_m)
            best_d = torch.maximum(best_d, d2)
    return best_m


def disocclusion_mask(pos_tw: torch.Tensor, valid: torch.Tensor,
                      prev_depth: torch.Tensor, prev_tw_to_clip: torch.Tensor,
                      history_valid: torch.Tensor, tol: float = 0.02
                      ) -> torch.Tensor:
    """Reproject each surface point into the previous frame and compare
    depths (reference disocclusion_mask.hlsl) -> (H,W) f32, 1 = history
    unusable."""
    h, w = prev_depth.shape
    m = prev_tw_to_clip
    c = (pos_tw[..., 0:1] * m[0] + pos_tw[..., 1:2] * m[1] +
         pos_tw[..., 2:3] * m[2] + m[3])
    wc = torch.clamp_min(c[..., 3], 1e-6)
    px = (c[..., 0] / wc * 0.5 + 0.5) * w
    py = (0.5 - c[..., 1] / wc * 0.5) * h
    z_expect = c[..., 2] / wc
    on = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (c[..., 3] > 0)
    xi = torch.clamp(f2i(px), 0, w - 1).long()
    yi = torch.clamp(f2i(py), 0, h - 1).long()
    consistent = torch.abs(prev_depth[yi, xi] - z_expect) < tol
    ok = on & consistent & valid & (history_valid > 0.5)
    return 1.0 - ok.to(torch.float32)


class TSRConfig(NamedTuple):
    """reference: tsr.cpp:17-28. `mode`: "gather" (per-pixel history
    resample, chord_tpu's default), "global" (one screen-wide shift by the
    mean motion) or "tile" (per-tile reprojection, K4)."""

    blend: float = 0.1
    sharpness: float = 0.25
    bilinear_history: bool = True
    mode: str = "gather"


def _sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """img (H,W,C), x/y pixel coordinates (H,W) -> (H,W,C) f32, edge-clamped
    (chord_tpu post.py:361). A bf16 `img` is fetched as bf16 and promoted
    to f32 by the f32 weights."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(x - 0.5)
    y0 = torch.floor(y - 0.5)
    fx = ((x - 0.5) - x0)[..., None]
    fy = ((y - 0.5) - y0)[..., None]
    x0i = torch.clamp(f2i(x0), 0, w - 1).long()
    y0i = torch.clamp(f2i(y0), 0, h - 1).long()
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    return (img[y0i, x0i] * (1 - fx) * (1 - fy) +
            img[y0i, x1i] * fx * (1 - fy) +
            img[y1i, x0i] * (1 - fx) * fy + img[y1i, x1i] * fx * fy)


def _neighborhood_minmax(img: torch.Tensor, cross_only: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 (or cross) min/max over (H,W,C) via shifted planes."""
    lo = hi = img
    taps = ([(-1, 0), (1, 0), (0, -1), (0, 1)] if cross_only else
            [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if (dy, dx) != (0, 0)])
    for dy, dx in taps:
        sh = torch.roll(torch.roll(img, dy, 0), dx, 1)
        lo = torch.minimum(lo, sh)
        hi = torch.maximum(hi, sh)
    return lo, hi


def _resolve_with_hist(color, hist, resid, history_valid, cfg: TSRConfig):
    """Neighbourhood clamp, residual-adaptive blend, unsharp sharpen."""
    lo, hi = _neighborhood_minmax(color, cross_only=True)
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    alpha = torch.clamp(cfg.blend + resid * 0.5, cfg.blend, 1.0)[..., None]
    alpha = torch.maximum(alpha, 1.0 - history_valid)
    out = color * alpha + hist * (1.0 - alpha)
    blur = (torch.roll(out, 1, 0) + torch.roll(out, -1, 0) +
            torch.roll(out, 1, 1) + torch.roll(out, -1, 1)) * 0.25
    return torch.clamp_min(out + (out - blur) * cfg.sharpness, 0.0)


def _wrap_index(n: int, shift: torch.Tensor) -> torch.Tensor:
    """(arange(n) + shift) mod n, the index of torch.roll(x, -shift) along
    an axis of n; `shift` is a device int32 scalar, so the roll stays on the
    device (no host read of the shift)."""
    i = torch.arange(n, dtype=torch.int32, device=shift.device)
    return torch.remainder(i + shift, n).long()


def temporal_resolve_global(color, motion_ndc, history, history_valid,
                            cfg: TSRConfig) -> torch.Tensor:
    """Gather-free TAA: the history shifted by the mean screen motion (its
    floor as four wrap-around rolls, the fraction as a bilinear blend of
    them), blended with an alpha that rises with each pixel's residual to
    that mean (chord_tpu post.py:411-445)."""
    h, w = color.shape[:2]
    mx = torch.mean(motion_ndc[..., 0]) * (w * 0.5)     # pixels right
    my = -torch.mean(motion_ndc[..., 1]) * (h * 0.5)    # pixels down
    ix = f2i(torch.floor(mx))
    iy = f2i(torch.floor(my))
    fx = mx - ix.to(torch.float32)
    fy = my - iy.to(torch.float32)
    # roll(history, (-iy, -ix)) and its +1 neighbours, as index gathers
    r0, r1 = _wrap_index(h, iy), _wrap_index(h, iy + 1)
    c0, c1 = _wrap_index(w, ix), _wrap_index(w, ix + 1)
    rows0, rows1 = history.index_select(0, r0), history.index_select(0, r1)
    h00, h01 = rows0.index_select(1, c0), rows0.index_select(1, c1)
    h10, h11 = rows1.index_select(1, c0), rows1.index_select(1, c1)
    hist = (h00 * (1 - fx) * (1 - fy) + h01 * fx * (1 - fy) +
            h10 * (1 - fx) * fy + h11 * fx * fy)
    rx = motion_ndc[..., 0] * (w * 0.5) - mx
    ry = -motion_ndc[..., 1] * (h * 0.5) - my
    resid = torch.sqrt(rx * rx + ry * ry)
    return _resolve_with_hist(color, hist, resid, history_valid, cfg)


def temporal_resolve_tile(color, motion_ndc, history, history_valid,
                          cfg: TSRConfig) -> torch.Tensor:
    """Tile-local TAA: per-tile mean-motion history reprojection (K4)."""
    from .tile_reproject import tile_reproject

    h, w = color.shape[:2]
    mot_px = torch.stack([motion_ndc[..., 0] * (w * 0.5),
                          -motion_ndc[..., 1] * (h * 0.5)], -1)
    hist, resid = tile_reproject(history, mot_px)
    return _resolve_with_hist(color, hist, resid, history_valid, cfg)


def temporal_resolve(color: torch.Tensor, motion_ndc: torch.Tensor,
                     history: torch.Tensor, history_valid: torch.Tensor,
                     cfg: TSRConfig,
                     disocclusion: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """TAA-style accumulation at render size (chord_tpu post.py:502-548).
    `global` and `tile` reproject the history as their resolves do and
    restart disoccluded pixels from the current colour. `gather`: each
    pixel fetches its history at its previous position (bilinear from a
    bf16 copy of the history, or nearest), clamps it into the current
    frame's cross neighbourhood, blends (off-screen and invalid history
    restart) and sharpens against the wrap-around 4-neighbour mean.
    `disocclusion` (H,W), 1 = history unusable, restarts those pixels."""
    if cfg.mode in ("global", "tile"):
        f = (temporal_resolve_tile if cfg.mode == "tile"
             else temporal_resolve_global)
        out = f(color, motion_ndc, history, history_valid, cfg)
        if disocclusion is not None:
            out = color + (out - color) * (1.0 - disocclusion[..., None])
        return out
    h, w = color.shape[:2]
    dev = color.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    # motion is NDC (x right, y up); pixels are y-down
    px_prev = xs - motion_ndc[..., 0] * (w * 0.5)
    py_prev = ys + motion_ndc[..., 1] * (h * 0.5)
    hist_bf16 = history.to(torch.bfloat16)
    if cfg.bilinear_history:
        hist = _sample_bilinear(hist_bf16, px_prev, py_prev).float()
    else:
        xi = torch.clamp(f2i(px_prev), 0, history.shape[1] - 1).long()
        yi = torch.clamp(f2i(py_prev), 0, history.shape[0] - 1).long()
        hist = hist_bf16[yi, xi].float()
    lo, hi = _neighborhood_minmax(color, cross_only=True)
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    offscreen = ((px_prev < 0) | (px_prev > w) | (py_prev < 0) |
                 (py_prev > h)).to(torch.float32)[..., None]
    alpha = torch.clamp_min(torch.maximum(1.0 - history_valid, offscreen),
                            cfg.blend)
    if disocclusion is not None:
        alpha = torch.maximum(alpha, disocclusion[..., None])
    out = color * alpha + hist * (1.0 - alpha)
    blur = (_roll(out, 1, 0) + _roll(out, -1, 0) + _roll(out, 0, 1) +
            _roll(out, 0, -1)) * 0.25
    return torch.clamp_min(out + (out - blur) * cfg.sharpness, 0.0)


def _linear_weights(in_size: int, out_size: int, scale, translation,
                    device) -> torch.Tensor:
    """(in, out) triangle-kernel resampling weights, the weight matrix of
    jax.image.scale_and_translate(method="linear", antialias=True) for an
    upscale: sample_f = (o+0.5)/s - t/s - 0.5, weights renormalised per
    output, zeroed where the sample lies outside [-0.5, in-0.5]."""
    inv = 1.0 / scale
    kernel_scale = torch.clamp_min(inv, 1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=device)
    sample_f = (o + 0.5) * inv - translation * inv - 0.5
    i = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[None, :] - i[:, None]) / kernel_scale
    wts = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = wts.sum(dim=0, keepdim=True)
    one = torch.ones((), device=device)
    wts = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                      wts / torch.where(total != 0, total, one),
                      torch.zeros((), device=device))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros((), device=device))


def _resample(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor
              ) -> torch.Tensor:
    """(h,w,c) through (h,H) and (w,W) weights -> (H,W,c)."""
    y = torch.einsum("hwc,hH->Hwc", x, wy)
    return torch.einsum("Hwc,wW->HWc", y, wx)


def temporal_upscale_global(color, motion_ndc, history, history_valid,
                            jitter_px, cfg: TSRConfig, post_h: int,
                            post_w: int) -> torch.Tensor:
    """Jitter-compensated linear render->post resample of colour, linear
    resize of motion, then the tile-mode (K4) or global-mode resolve at
    post res, as cfg.mode says."""
    h, w = color.shape[:2]
    dev = color.device
    sy = torch.tensor(post_h / h, dtype=torch.float32, device=dev)
    sx = torch.tensor(post_w / w, dtype=torch.float32, device=dev)
    cur = _resample(color,
                    _linear_weights(h, post_h, sy, jitter_px[1] * (post_h / h),
                                    dev),
                    _linear_weights(w, post_w, sx, jitter_px[0] * (post_w / w),
                                    dev))
    zero = torch.zeros((), device=dev)
    mot = _resample(motion_ndc,
                    _linear_weights(h, post_h, torch.tensor(
                        post_h / h, device=dev), zero, dev),
                    _linear_weights(w, post_w, torch.tensor(
                        post_w / w, device=dev), zero, dev))
    f = (temporal_resolve_tile if cfg.mode == "tile"
         else temporal_resolve_global)
    return f(cur, mot, history, history_valid, cfg)


def temporal_upscale(color, motion_ndc, history, history_valid, jitter_px,
                     cfg: TSRConfig, post_h: int, post_w: int,
                     disocclusion: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """TSR with render->post upscale (chord_tpu post.py:551-622). `tile`
    and `global` resample, resolve at post res (temporal_upscale_global)
    and restart disoccluded pixels from the nearest-upsampled current
    frame. `gather` samples colour and motion bilinearly at each post
    pixel's jittered render position, fetches the history bilinearly from
    a bf16 copy at the previous position, clamps, blends (off-screen,
    invalid and, bilinearly sampled, disoccluded pixels restart) and
    sharpens."""
    if cfg.mode in ("global", "tile"):
        out = temporal_upscale_global(color, motion_ndc, history,
                                      history_valid, jitter_px, cfg, post_h,
                                      post_w)
        if disocclusion is not None:
            k = (-(-post_h // color.shape[0]), -(-post_w // color.shape[1]))
            cur0 = upsample_nearest(color, k, post_h, post_w)
            dis0 = upsample_nearest(disocclusion, k, post_h, post_w)
            out = cur0 + (out - cur0) * (1.0 - dis0[..., None])
        return out
    h, w = color.shape[:2]
    dev = color.device
    # post-pixel centres in render-pixel coordinates, shifted by the jitter
    ys = ((torch.arange(post_h, dtype=torch.float32, device=dev)[:, None] +
           0.5) * (h / post_h)).expand(post_h, post_w) - jitter_px[1]
    xs = ((torch.arange(post_w, dtype=torch.float32, device=dev)[None, :] +
           0.5) * (w / post_w)).expand(post_h, post_w) - jitter_px[0]
    cur = _sample_bilinear(color, xs, ys)
    mot = _sample_bilinear(motion_ndc, xs, ys)
    pxs = torch.arange(post_w, dtype=torch.float32, device=dev)[None, :] + 0.5
    pys = torch.arange(post_h, dtype=torch.float32, device=dev)[:, None] + 0.5
    px_prev = pxs - mot[..., 0] * (post_w * 0.5)
    py_prev = pys + mot[..., 1] * (post_h * 0.5)
    hist = _sample_bilinear(history.to(torch.bfloat16), px_prev,
                            py_prev).float()
    lo, hi = _neighborhood_minmax(cur, cross_only=True)
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    offscreen = ((px_prev < 0) | (px_prev > post_w) | (py_prev < 0) |
                 (py_prev > post_h)).to(torch.float32)[..., None]
    alpha = torch.clamp_min(torch.maximum(1.0 - history_valid, offscreen),
                            cfg.blend)
    if disocclusion is not None:
        alpha = torch.maximum(alpha, _sample_bilinear(disocclusion[..., None],
                                                      xs, ys))
    out = cur * alpha + hist * (1.0 - alpha)
    blur = (_roll(out, 1, 0) + _roll(out, -1, 0) + _roll(out, 0, 1) +
            _roll(out, 0, -1)) * 0.25
    return torch.clamp_min(out + (out - blur) * cfg.sharpness, 0.0)
