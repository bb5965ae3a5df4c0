"""The shadow-evaluate fault bisection of chord_tpu, in PyTorch (port of
tools/repro_eval_kernel.py).

chord_tpu's tool grows the PCSS evaluate + temporal-mask subgraph of the
frame, one variant at a time, to find the op pattern its TPU worker faulted
on. The port keeps the 22 variants at the same bench shapes (1080p, the
eval grid at 1/4 and phase 2: 270x480 and 135x240; ShadowConfig(): 4 x
1024^2 maps) and the same seeded inputs, each with the PyTorch meaning of
its composition:

  eval, eval_noign        evaluate_shadow alone, with / without IGN noise
  phase                   + the frame's phase shift (roll) and subsample
  temporal                + reprojection gather, residual blend, upsample
  gather, frame_gather    the flat 4M-element gather, computed / matmul
                          chain indices
  t_roll, t_up, t_uproll, t_gather2d, t_blend, t_gatherflat
                          the temporal blend's pieces alone
  scan_eval, scan_eval_nocarry
                          two evaluate steps in a loop, with / without the
                          in-place refresh of one cascade per step
  tm_up, tm_gather        evaluate composed with pieces of the blend
  tm_barrier              the full blend behind an identity (PyTorch runs
                          ops one by one: nothing fuses across them)
  tm_pallas               ... behind the fusion barrier, kernel K9
  tm_copy                 ... behind a .clone()
  tm_dual                 blend and evaluate result both returned
  tm_split                evaluate and blend as two separate calls
  tm_hist                 blend of last frame's q, this frame's q returned

Every float -> int32 cast saturates as XLA's does (ops/_util.f2i): the
reprojection reaches ~1e10, where a plain .to(torch.int32) is undefined.

    python3 -m chord_tpu_torch.tools.repro_eval_kernel tm_pallas
    REPRO_CPU=1 python3 -m chord_tpu_torch.tools.repro_eval_kernel eval
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops import fusion_barrier
from ..ops import post
from ..ops import shadow as shadow_ops
from ..ops._util import f2i
from ..ops.bluenoise import interleaved_gradient_noise

VARIANTS = ("eval", "eval_noign", "phase", "temporal", "gather",
            "frame_gather",
            "t_roll", "t_up", "t_uproll", "t_gather2d", "t_blend",
            "t_gatherflat",
            "scan_eval", "scan_eval_nocarry",
            "tm_up", "tm_gather", "tm_barrier", "tm_pallas", "tm_copy",
            "tm_dual", "tm_split", "tm_hist")

SCFG = shadow_ops.ShadowConfig()
H, W = 1080, 1920
PH = SCFG.temporal_phase                          # 2
HE, WE = H // SCFG.eval_res_div, W // SCFG.eval_res_div     # 270x480
HP, WP = HE // PH, WE // PH                       # 135x240


def _phase(fc: int) -> Tuple[int, int]:
    pidx = fc % (PH * PH)
    return pidx // PH, pidx % PH


def _eval_phase(pos, nrm, sun, maps, mats, fc):
    """evaluate_shadow on this frame's phase of the eval grid."""
    py_, px_ = _phase(fc)
    pos_e = torch.roll(pos, (-py_, -px_), dims=(0, 1))[::PH, ::PH]
    nrm_e = torch.roll(nrm, (-py_, -px_), dims=(0, 1))[::PH, ::PH]
    noise = interleaved_gradient_noise(HP, WP, fc, device=pos.device)
    return shadow_ops.evaluate_shadow(pos_e, nrm_e, sun, maps, mats, SCFG,
                                      noise=noise)


def _reproject(pos, pm, he: int, we: int):
    """The previous frame's pixel of every receiver -> (yi, xi, on)."""
    c = (pos[..., 0:1] * pm[0] + pos[..., 1:2] * pm[1] +
         pos[..., 2:3] * pm[2] + pm[3])
    wc = torch.clamp_min(c[..., 3], 1e-6)
    px2 = (c[..., 0] / wc * 0.5 + 0.5) * we
    py2 = (0.5 - c[..., 1] / wc * 0.5) * he
    on = ((px2 >= 0) & (px2 < we) & (py2 >= 0) & (py2 < he) &
          (c[..., 3] > 0))
    xi = torch.clamp(f2i(px2), 0, we - 1).long()
    yi = torch.clamp(f2i(py2), 0, he - 1).long()
    return yi, xi, on


def _upsample_roll(q, fc):
    py_, px_ = _phase(fc)
    return torch.roll(post.upsample_nearest(q, PH, HE, WE), (py_, px_),
                      dims=(0, 1))


def _blend(sq, pos, pm, prev_mask):
    """The temporal mask blend of the upsampled q with the reprojected
    history."""
    yi, xi, on = _reproject(pos, pm, HE, WE)
    prev = prev_mask[yi, xi]
    resid = torch.abs(prev - sq)
    alpha = 0.7 * on.to(torch.float32) * torch.exp(-4.0 * resid)
    return sq + (prev - sq) * alpha


def build(variant: str, device=None) -> Tuple[Callable, tuple]:
    """The variant's function and inputs, drawn from default_rng(0) in the
    reference's order -> (run, args): run(*args, fc) with fc the frame
    index (an int); `tm_hist` takes last frame's q as one more argument.
    `device` defaults to the card."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected "
                         f"{sorted(VARIANTS)}")
    dev = torch.device("cuda") if device is None else torch.device(device)
    n, r = SCFG.cascade_count, SCFG.resolution

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    rng = np.random.default_rng(0)
    pos = f32(rng.uniform(-20, 20, (HP, WP, 3)))
    nrm_ = rng.normal(size=(HP, WP, 3))
    nrm = f32(nrm_ / np.linalg.norm(nrm_, axis=-1, keepdims=True))
    maps = f32(rng.uniform(0, 1, (n, r, r)))
    sun = torch.tensor([0.3, 0.8, 0.5], dtype=torch.float32)
    sun = sun / torch.sqrt((sun * sun).sum())
    mats, _ = shadow_ops.fit_cascades(
        np.array([0.0, 0.0, -1.0]), sun.numpy(), np.radians(60.0), 16 / 9,
        SCFG)
    mats = f32(mats)
    sun = sun.to(dev)
    args = (pos, nrm, maps, mats)

    if variant in ("phase", "temporal") or variant.startswith("tm_"):
        pos = f32(rng.uniform(-20, 20, (HE, WE, 3)))
        nrm = f32(nrm_[:1, :1] * np.ones((HE, WE, 3)))
        nrm = nrm / torch.sqrt((nrm * nrm).sum(-1, keepdim=True))
        args = (pos, nrm, maps, mats)
        if variant != "phase":
            prev_mask = f32(rng.uniform(0, 1, (HE, WE)))
            pm = f32(rng.normal(size=(4, 4)))
    elif variant.startswith("t_"):
        q0 = f32(rng.uniform(0, 1, (HP, WP)))
        prev_mask = f32(rng.uniform(0, 1, (HE, WE)))
        pm = f32(rng.normal(size=(4, 4)))
        args = (f32(rng.uniform(-20, 20, (HE, WE, 3))), nrm, maps, mats)

    if variant in ("scan_eval", "scan_eval_nocarry"):
        def run(pos, nrm, maps, mats, fc):
            m = maps.clone() if variant == "scan_eval" else maps
            qs = []
            for i in range(2):
                if variant == "scan_eval":     # refresh cascade i % n
                    m[i % n] = 0.25 * (1.0 + float(i))
                noise = interleaved_gradient_noise(HP, WP, i, device=dev)
                q = shadow_ops.evaluate_shadow(pos, nrm, sun, m, mats, SCFG,
                                               noise=noise)
                qs.append(q.mean())
            return torch.stack(qs)
    elif variant in ("eval", "eval_noign"):
        def run(pos, nrm, maps, mats, fc):
            noise = (interleaved_gradient_noise(HP, WP, fc, device=dev)
                     if variant == "eval" else None)
            return shadow_ops.evaluate_shadow(pos, nrm, sun, maps, mats,
                                              SCFG, noise=noise)
    elif variant == "phase":
        def run(pos, nrm, maps, mats, fc):
            return _eval_phase(pos, nrm, sun, maps, mats, fc)
    elif variant in ("tm_up", "tm_gather", "tm_barrier", "tm_pallas",
                     "tm_copy", "temporal"):
        def run(pos, nrm, maps, mats, fc):
            q = _eval_phase(pos, nrm, sun, maps, mats, fc)
            if variant == "tm_pallas":
                q = fusion_barrier.fusion_barrier(q)
            elif variant == "tm_copy":
                q = q.clone()
            if variant == "tm_gather":
                # blend with a reprojection gather at eval res (no upsample
                # or roll between evaluate and the gather-blend)
                py_, px_ = _phase(fc)
                pos_e = torch.roll(pos, (-py_, -px_), dims=(0, 1))[::PH, ::PH]
                yi, xi, _ = _reproject(pos_e, pm, HE, WE)
                return q + (prev_mask[yi, xi] - q) * 0.5
            sq = _upsample_roll(q, fc)
            if variant == "tm_up":
                return sq
            return _blend(sq, pos, pm, prev_mask)
    elif variant in ("tm_dual", "tm_split", "tm_hist"):
        def blend_part(pos, q, fc):
            return _blend(_upsample_roll(q, fc), pos, pm, prev_mask)

        if variant == "tm_hist":
            def run(pos, nrm, maps, mats, fc, q_prev):
                q_new = _eval_phase(pos, nrm, sun, maps, mats, fc)
                return blend_part(pos, q_prev, fc), q_new
        elif variant == "tm_dual":
            def run(pos, nrm, maps, mats, fc):
                q = _eval_phase(pos, nrm, sun, maps, mats, fc)
                return blend_part(pos, q, fc), q
        else:       # tm_split: two separate calls
            def run(pos, nrm, maps, mats, fc):
                q = _eval_phase(pos, nrm, sun, maps, mats, fc)
                return blend_part(pos, q, fc)
    elif variant.startswith("t_"):
        def run(pos, nrm, maps, mats, fc):
            q = q0 * (1.0 + 0.1 * torch.tensor(float(fc), device=dev))
            if variant == "t_roll":
                return torch.roll(prev_mask, _phase(fc), dims=(0, 1))
            if variant == "t_up":
                return post.upsample_nearest(q, PH, HE, WE)
            if variant == "t_uproll":
                return _upsample_roll(q, fc)
            if variant in ("t_gather2d", "t_gatherflat"):
                yi, xi, _ = _reproject(pos, pm, HE, WE)
                if variant == "t_gatherflat":
                    return prev_mask.reshape(-1)[yi * WE + xi]
                return prev_mask[yi, xi]
            return _blend(_upsample_roll(q, fc), pos, pm, prev_mask)
    else:           # gather, frame_gather
        flat = maps.reshape(-1)

        def run(pos, nrm, maps, mats, fc):
            if variant == "frame_gather":
                m = mats[0]
                lp = (pos[..., 0:1] * m[0] + pos[..., 1:2] * m[1] +
                      pos[..., 2:3] * m[2] + m[3])
                u = (lp[..., 0] * 0.5 + 0.5) * r
                v = (0.5 - lp[..., 1] * 0.5) * r
            else:
                u = torch.remainder(pos[..., 0] * 13.7, r)
                v = torch.remainder(pos[..., 1] * 7.3, r)
            cascade = fc % 4
            acc = torch.zeros((HP, WP), dtype=torch.float32, device=dev)
            for s in range(6):
                x = torch.clamp(f2i(u + s), 0, r - 1)
                y = torch.clamp(f2i(v - s), 0, r - 1)
                acc += flat[(cascade * (r * r) + y * r + x).long()]
            return acc
    return run, args


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def run_variant(variant: str, device=None, steady: int = 3) -> dict:
    """The reference tool's run: one call at frame 1, then `steady` calls
    at frames 0.. (tm_hist feeding each call's q to the next), each copied
    to the host; prints the same two lines. -> {"out": the first call's
    outputs on the host, "sum", "first_s", "steady_ms"}."""
    run, args = build(variant, device)
    dev = args[0].device
    hist = variant == "tm_hist"

    def call(i, qp):
        return run(*args, i, qp) if hist else run(*args, i)

    q_prev = torch.zeros((HP, WP), dtype=torch.float32, device=dev)
    t0 = time.time()
    out = [a.cpu() for a in _leaves(call(1, q_prev))]
    first_s = time.time() - t0
    tot = sum(float(np.sum(a.numpy())) for a in out)
    print(f"{variant} compile+run ok in {first_s:.1f}s sum={tot:.3f}")
    t0 = time.time()
    for i in range(steady):
        res = call(i, q_prev)
        if hist:
            q_prev = res[1]
        [a.cpu() for a in _leaves(res)]
    steady_ms = (time.time() - t0) / max(steady, 1) * 1000
    print(f"{variant} steady ok {steady_ms:.1f} ms")
    return dict(out=out, sum=tot, first_s=first_s, steady_ms=steady_ms)


def main(argv: Optional[list] = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    variant = argv[0] if argv else "eval"
    if variant not in VARIANTS:
        sys.exit(f"unknown variant {variant!r}; expected {sorted(VARIANTS)}")
    return run_variant(variant, "cpu" if os.environ.get("REPRO_CPU")
                       else None)


if __name__ == "__main__":
    main()
