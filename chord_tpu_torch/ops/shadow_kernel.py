"""Kernel K6: the PCSS taps over the cascaded shadow-map stack.

    pcss   CUDA kernel csrc/pcss.cu (CUDA tensors) or pcss_plain
           (ops/shadow.py, CPU tensors)

Replaces chord_tpu/ops/shadow_kernel.py::_pcss_kernel (:145, via
evaluate_shadow_pallas :254). The Pallas kernel's per-tile cascade, level
pyramid, aligned DMA window and one-hot-matmul taps exist because the TPU
cannot gather; the CUDA kernel computes the per-pixel function
(chord_tpu evaluate_shadow) with direct loads, one thread per eval pixel.
The inputs are ops/shadow.py's ShadowPrepass, shared with the plain
version, so kernel and plain version see identical tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from .shadow import (PCF_RADIUS_MAX, ShadowConfig, ShadowPrepass,
                     pcss_offsets, pcss_plain)

MAX_TAPS = 16    # PcssParams' offset slots (csrc/pcss.cu)


class _PcssParams(ctypes.Structure):
    """csrc/pcss.cu PcssParams, passed by value."""
    _fields_ = [("blk", (ctypes.c_float * 2) * MAX_TAPS),
                ("pcf", (ctypes.c_float * 2) * MAX_TAPS),
                ("n_blk", ctypes.c_int), ("n_pcf", ctypes.c_int),
                ("pcf_radius", ctypes.c_float),
                ("pcf_radius_max", ctypes.c_float),
                ("light_size", ctypes.c_float)]


@functools.lru_cache(maxsize=64)
def _params(cfg: ShadowConfig) -> _PcssParams:
    """The kernel's offsets and scalars for `cfg`, built once per config
    (ctypes passes the struct by value, a copy per call)."""
    blk, pcf = pcss_offsets(cfg)
    if not (1 <= len(blk) <= MAX_TAPS and 1 <= len(pcf) <= MAX_TAPS):
        raise ValueError(f"PCSS sample counts ({len(blk)}, {len(pcf)}) must "
                         f"lie in [1, {MAX_TAPS}]")
    p = _PcssParams(n_blk=len(blk), n_pcf=len(pcf),
                    pcf_radius=cfg.pcf_radius_px,
                    pcf_radius_max=PCF_RADIUS_MAX,
                    light_size=cfg.light_size_world)
    for s, (x, y) in enumerate(blk):
        p.blk[s][0], p.blk[s][1] = x, y
    for s, (x, y) in enumerate(pcf):
        p.pcf[s][0], p.pcf[s][1] = x, y
    return p


def pcss(shadow_maps: torch.Tensor, pre: ShadowPrepass,
         cfg: ShadowConfig) -> torch.Tensor:
    """Kernel K6: (N,R,R) f32 reverse-Z stack + the prepass -> (H,W) f32
    visibility in [0,1]. CPU tensors -> pcss_plain."""
    if not shadow_maps.is_cuda:
        return pcss_plain(shadow_maps, pre, cfg)
    if shadow_maps.dim() != 3 or shadow_maps.shape[1] != shadow_maps.shape[2]:
        raise ValueError(f"shadow_maps must be (N,R,R) "
                         f"(got {tuple(shadow_maps.shape)})")
    n, r, _ = shadow_maps.shape
    hw = tuple(pre.u.shape)
    _cuda.check(shadow_maps, "shadow_maps", torch.float32)
    _cuda.check(pre.cascade, "cascade", torch.int32, hw)
    for name in ("u", "v", "z_cmp", "z_recv", "ca", "sa"):
        _cuda.check(getattr(pre, name), name, torch.float32, hw)
    _cuda.check(pre.depth_range, "depth_range", torch.float32, (n,))
    _cuda.check(pre.texel, "texel", torch.float32, (n,))
    out = torch.empty(hw, dtype=torch.float32, device=shadow_maps.device)
    p = _cuda.ptr
    _cuda.launch("chord_pcss", p(shadow_maps), _cuda.cint(r), p(pre.cascade),
                 p(pre.u), p(pre.v), p(pre.z_cmp), p(pre.z_recv), p(pre.ca),
                 p(pre.sa), p(pre.depth_range), p(pre.texel),
                 _cuda.cint(out.numel()), _params(cfg), p(out),
                 _cuda.stream())
    pcss.launches += 1
    return out


pcss.launches = 0
