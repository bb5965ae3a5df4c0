"""Visibility packing and frame history (port of
chord_tpu/rhi/framebuffer.py).

Visibility ids are kept as int32 BIT PATTERNS inside the port: chord_tpu's
raster compares payloads as signed int32, and torch.uint32 lacks most ops.
`vis_to_uint32` converts at the API edge only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# (instanceId+1):25 | triangleId:7; 0 = empty sky pixel
# (reference: shader/base.h:410-413)
TRI_BITS = 7
TRI_MASK = (1 << TRI_BITS) - 1


def pack_visibility(instance_id: torch.Tensor,
                    tri_id: torch.Tensor) -> torch.Tensor:
    """(instanceId+1):25 | triangleId:7 -> int32 bits; instance_id==-1 -> 0."""
    packed = ((instance_id + 1).to(torch.int32) << TRI_BITS) | (
        tri_id.to(torch.int32) & TRI_MASK)
    return torch.where(instance_id >= 0, packed, torch.zeros_like(packed))


def unpack_visibility(vis: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 visibility bits -> (instance_id with -1 = empty, tri_id).
    The shift is logical (the ids are unsigned on the wire)."""
    vis = vis.to(torch.int32)
    inst = ((vis >> TRI_BITS) & ((1 << (32 - TRI_BITS)) - 1)) - 1
    tri = vis & TRI_MASK
    return inst, tri


def vis_to_uint32(vis: torch.Tensor):
    """int32 visibility bits -> numpy uint32 (for comparison with
    chord_tpu's uint32 render targets)."""
    return vis.detach().cpu().numpy().view("uint32")


@dataclass
class FrameHistory:
    """State carried frame -> frame. `valid` gates all history reads; a
    camera cut sets valid=0 (reference clearHistory). chord_tpu's history
    also carries DDGI state, which is not ported."""

    valid: torch.Tensor         # () f32 0/1
    frame_count: torch.Tensor   # () i32
    hzb_flat: torch.Tensor      # (total,) f32 flattened min-depth pyramid
    depth: torch.Tensor         # (H,W) f32 previous depth
    exposure: torch.Tensor      # () f32 adapted exposure
    tsr_color: torch.Tensor     # (Hp,Wp,3) f32 accumulated TSR colour
    depth_range: torch.Tensor   # (2,) f32 view-space (near, far) of the
                                # frame's valid depth (next frame's fit)
    shadow_mask: torch.Tensor   # (Hs,Ws) f32 temporal PCSS mask (1 = lit)
    # cached cascades (one re-renders per frame, round robin), each with
    # the fit matrix it was rendered with
    shadow_maps: torch.Tensor   # (N,R,R) f32 reverse-Z ((1,1,1) when off)
    shadow_mats: torch.Tensor   # (N,4,4) f32 tw -> light of each cached map
    # GI (reference GIContext): the world SH cache, the screen probes' packed
    # SH3 + numSample and depth, the half-res diffuse history and the
    # reduced-res specular history; (1,1,*) placeholders where off
    gi_cache: torch.Tensor      # (C,D^3,28) f32
    probe_sh: torch.Tensor      # (Ph,Pw,28) f32
    probe_depth: torch.Tensor   # (Ph,Pw) f32 probe ndc depth (reverse-Z)
    gi_diffuse: torch.Tensor    # (Hh,Wh,3) f32
    gi_specular: torch.Tensor   # (Hq,Wq,3) f32, Hq = H / sample_res_div

    @classmethod
    def empty(cls, h: int, w: int, post_h: Optional[int] = None,
              post_w: Optional[int] = None, gi_cfg=None,
              shadow_div: int = 2, shadow_cascades: int = 0,
              shadow_res: int = 1, shadow_phase: int = 1,
              probe_tile: int = 0, device=None) -> "FrameHistory":
        """Invalid (valid=0) history on `device` (None = the card), with
        chord_tpu's shapes. `gi_cfg` (a GIConfig; None = GI off) sizes the
        world cache and the specular history, `probe_tile` (0 = off) the
        screen probes and the half-res diffuse history. `shadow_div` is
        the PCSS eval divisor (ShadowConfig.eval_res_div), `shadow_cascades`
        / `shadow_res` size the cascade cache (0 = off). `shadow_phase` is
        accepted as chord_tpu's signature has it; the phase-decimated eval
        does not ride in the history."""
        from ..ops.gi import GIConfig, sh_size
        from ..ops.hzb import hzb_layout
        from ..utils.device import resolve

        del shadow_phase
        device = resolve(device)
        ph, pw = post_h or h, post_w or w
        ws, hs, offs = hzb_layout(w, h)
        total = offs[-1] + ws[-1] * hs[-1]
        n = max(shadow_cascades, 1)
        f32 = dict(dtype=torch.float32, device=device)
        gi_shape = sh_size(gi_cfg or GIConfig(cascades=1, probe_dim=2))
        pr_h = pr_w = gh = gw = 1
        if probe_tile:
            pr_h, pr_w = -(-h // probe_tile), -(-w // probe_tile)
            gh, gw = -(-h // 2), -(-w // 2)
        # the specular history is written by every GI mode
        sh_ = sw_ = 1
        if gi_cfg is not None:
            sh_, sw_ = (-(-h // gi_cfg.sample_res_div),
                        -(-w // gi_cfg.sample_res_div))
        return cls(
            valid=torch.zeros((), **f32),
            frame_count=torch.zeros((), dtype=torch.int32, device=device),
            hzb_flat=torch.zeros((total,), **f32),
            depth=torch.zeros((h, w), **f32),
            exposure=torch.ones((), **f32),
            tsr_color=torch.zeros((ph, pw, 3), **f32),
            depth_range=torch.zeros((2,), **f32),
            shadow_mask=torch.ones((-(-h // shadow_div), -(-w // shadow_div)),
                                   **f32),
            shadow_maps=torch.zeros((n, shadow_res, shadow_res), **f32),
            shadow_mats=torch.zeros((n, 4, 4), **f32),
            gi_cache=torch.zeros(gi_shape, **f32),
            probe_sh=torch.zeros((pr_h, pr_w, 28), **f32),
            probe_depth=torch.zeros((pr_h, pr_w), **f32),
            gi_diffuse=torch.zeros((gh, gw, 3), **f32),
            gi_specular=torch.zeros((sh_, sw_, 3), **f32),
        )
