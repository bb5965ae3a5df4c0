"""GPU-driven culling: object pre-cull, meshlet frustum + cone + Nanite LOD
cut + two-phase HZB occlusion, compacted into a bounded draw list (port of
chord_tpu/ops/cull.py; reference instance_culling.hlsl:48-208,
nanite_shared.hlsli:15-91, mesh_raster.cpp:269-330).

Compaction is a stable sort on the visibility key (torch.sort(stable=True)
+ gather, as chord_tpu's stable lax.sort): which pairs survive a capacity
cut depends on that order, so it is kept exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ._util import dot3
from .hzb import HZBPyramid, occlusion_test_spheres


class DrawList(NamedTuple):
    """Compacted visible draws (static capacity)."""

    object_id: torch.Tensor    # (cap,) i32, slack entries = 0
    meshlet_id: torch.Tensor   # (cap,) i32, slack entries = 0
    count: torch.Tensor        # () i32
    overflow: torch.Tensor     # () i32 visible pairs dropped


class PairObjectData(NamedTuple):
    m: torch.Tensor            # (P,4,4) object_to_tw
    nm: torch.Tensor           # (P,3,3) normal matrix
    two_sided: torch.Tensor    # (P,)
    valid: torch.Tensor        # (P,) bool
    masked: torch.Tensor       # (P,) bool
    blend: torch.Tensor        # (P,) bool
    scale: torch.Tensor        # (P,) max row norm of the linear block


def _sum3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a + b + c


def gather_pair_objects(pools, instances) -> PairObjectData:
    n = instances.object_to_tw.shape[0]
    table = torch.cat(
        [instances.object_to_tw.reshape(n, 16),
         instances.object_normal_mat.reshape(n, 9),
         instances.object_two_sided.reshape(n, 1).float(),
         instances.object_valid.reshape(n, 1).float(),
         instances.object_masked.reshape(n, 1).float(),
         instances.object_blend.reshape(n, 1).float()], dim=1)
    t = table[pools.pair_object.long()]                    # (P,29)
    p = t.shape[0]
    m = t[:, :16].reshape(p, 4, 4)
    sq = m[:, :3, :3] ** 2
    row = _sum3(sq[:, :, 0], sq[:, :, 1], sq[:, :, 2])      # (P,3)
    return PairObjectData(
        m=m, nm=t[:, 16:25].reshape(p, 3, 3), two_sided=t[:, 25],
        valid=t[:, 26] > 0.5, masked=t[:, 27] > 0.5, blend=t[:, 28] > 0.5,
        scale=torch.sqrt(row.amax(dim=1)))


def _to_tw(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Local point rows (P,>=3) through row-vector matrices (P,4,4)."""
    return (s[:, 0:1] * m[:, 0, :3] + s[:, 1:2] * m[:, 1, :3] +
            s[:, 2:3] * m[:, 2, :3] + m[:, 3, :3])


def pair_spheres_tw(pools, instances, od: Optional[PairObjectData] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair bounding spheres in translated world -> (centers, radii)."""
    if od is None:
        od = gather_pair_objects(pools, instances)
    s = pools.pair_cull[:, 0:4]
    return _to_tw(s, od.m), s[:, 3] * od.scale


def _plane_dist(centers: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """(N,3) x (K,4) -> (N,K) signed distances."""
    return (_sum3(centers[:, 0:1] * planes[None, :, 0],
                  centers[:, 1:2] * planes[None, :, 1],
                  centers[:, 2:3] * planes[None, :, 2]) + planes[None, :, 3])


def frustum_visible(centers: torch.Tensor, radii: torch.Tensor,
                    planes: torch.Tensor) -> torch.Tensor:
    """Sphere-vs-frustum: (P,) bool."""
    d = _plane_dist(centers, planes)
    return (d + radii[:, None] >= 0.0).all(dim=1)


def cone_visible(pools, instances, centers_tw: torch.Tensor,
                 od: Optional[PairObjectData] = None) -> torch.Tensor:
    """Meshlet normal-cone backface cull (camera at the TW origin)."""
    if od is None:
        od = gather_pair_objects(pools, instances)
    cone = pools.pair_cull[:, 4:8]
    nm = od.nm
    axis = (cone[:, 0:1] * nm[:, 0] + cone[:, 1:2] * nm[:, 1] +
            cone[:, 2:3] * nm[:, 2])
    axis = axis / torch.clamp_min(torch.sqrt(dot3(axis, axis)), 1e-8)[:, None]
    dist = torch.clamp_min(torch.sqrt(dot3(centers_tw, centers_tw)), 1e-8)
    view = centers_tw / dist[:, None]
    cutoff = cone[:, 3]
    return ((dot3(view, axis) < cutoff) | (cutoff >= 0.999) |
            (od.two_sided > 0.5))


def project_error_px(center_tw: torch.Tensor, radius_err: torch.Tensor,
                     proj_scale) -> torch.Tensor:
    """Screen-space size (pixels) of an error sphere; eye inside -> 1e9."""
    d2 = dot3(center_tw, center_tw)
    r2 = radius_err * radius_err
    inside = d2 <= r2 * 1.0001
    dist = torch.sqrt(torch.clamp_min(d2 - r2, 1e-12))
    px = radius_err * proj_scale / dist
    return torch.where(inside, torch.full_like(px, 1e9), px)


def lod_cut_visible(pools, instances, view_proj_scale,
                    error_px_threshold: float = 1.0,
                    od: Optional[PairObjectData] = None) -> torch.Tensor:
    """Nanite DAG cut: projected(parent_error) > threshold AND
    projected(error) <= threshold (reference nanite_shared.hlsli:15-49)."""
    if od is None:
        od = gather_pair_objects(pools, instances)
    c = _to_tw(pools.pair_cull[:, 8:12], od.m)
    cp = _to_tw(pools.pair_cull[:, 12:16], od.m)
    err0 = pools.pair_cull[:, 16]
    perr0 = pools.pair_cull[:, 17]
    err = err0 * od.scale
    perr = perr0 * od.scale
    e_px = project_error_px(c, torch.clamp_min(err, 1e-12), view_proj_scale)
    p_px = torch.where(perr0 >= 1e37, torch.full_like(perr0, 1e9),
                       project_error_px(cp, torch.clamp_min(perr, 1e-12),
                                        view_proj_scale))
    e_ok = (err0 <= 0.0) | (e_px <= error_px_threshold)
    return (p_px > error_px_threshold) & e_ok


def _stable_front(ok: torch.Tensor) -> torch.Tensor:
    """Permutation listing True entries first, each group in order (the
    stable sort on key 1-ok)."""
    key = 1 - ok.to(torch.int32)
    return torch.sort(key, stable=True).indices


def compact_draws(visible: torch.Tensor, pools, capacity: int) -> DrawList:
    """(P,) bool -> bounded draw list (instance_culling.hlsl:191-208)."""
    total = visible.to(torch.int32).sum().to(torch.int32)
    order = _stable_front(visible)
    obj_s = pools.pair_object[order]
    mesh_s = pools.pair_meshlet[order]
    p = visible.shape[0]
    if p < capacity:
        z = torch.zeros(capacity - p, dtype=torch.int32, device=visible.device)
        obj_s = torch.cat([obj_s, z])
        mesh_s = torch.cat([mesh_s, z])
    count = torch.clamp(total, max=capacity)
    live = torch.arange(capacity, dtype=torch.int32,
                        device=visible.device) < count
    zero = torch.zeros((), dtype=torch.int32, device=visible.device)
    return DrawList(object_id=torch.where(live, obj_s[:capacity], zero),
                    meshlet_id=torch.where(live, mesh_s[:capacity], zero),
                    count=count,
                    overflow=torch.clamp_min(total - capacity, 0))


class ActivePairs(NamedTuple):
    """Object pre-cull result: the bounded set of (instance, meshlet) pairs
    whose OBJECT passed the frustum test (instance_culling.hlsl:48-131)."""

    pair_object: torch.Tensor    # (A,) i32
    pair_meshlet: torch.Tensor   # (A,) i32
    pair_valid: torch.Tensor     # (A,) bool
    pair_cull: torch.Tensor      # (A,18) f32
    count: torch.Tensor          # () i32
    overflow: torch.Tensor       # () i32

    @property
    def num_pairs(self) -> int:
        return self.pair_object.shape[0]


def build_active_pairs(pools, instances, frustum_planes: torch.Tensor,
                       capacity: int) -> ActivePairs:
    """Object OBB frustum cull -> compact the surviving pairs."""
    obb = instances.object_obb_tw
    c = obb[:, 0:3]
    axes = obb[:, 3:12].reshape(-1, 3, 3)
    d = _plane_dist(c, frustum_planes)                       # (O,K)
    pr = frustum_planes[:, :3]
    proj = _sum3(axes[:, :, 0:1] * pr[None, None, :, 0],
                 axes[:, :, 1:2] * pr[None, None, :, 1],
                 axes[:, :, 2:3] * pr[None, None, :, 2])     # (O,3,K)
    r = torch.abs(proj).sum(dim=1)
    obj_ok = (d + r >= 0.0).all(dim=1) & instances.object_valid
    ok = pools.pair_valid & obj_ok[pools.pair_object.long()]
    total = ok.to(torch.int32).sum().to(torch.int32)
    p = ok.shape[0]
    a = min(capacity, p)
    idx_a = _stable_front(ok)[:a]
    count = torch.clamp(total, max=a)
    live = torch.arange(a, dtype=torch.int32, device=ok.device) < count
    zero = torch.zeros((), dtype=torch.int32, device=ok.device)
    return ActivePairs(
        pair_object=torch.where(live, pools.pair_object[idx_a], zero),
        pair_meshlet=torch.where(live, pools.pair_meshlet[idx_a], zero),
        pair_valid=live,
        pair_cull=pools.pair_cull[idx_a],
        count=count,
        overflow=torch.clamp_min(total - a, 0))


class CullResult(NamedTuple):
    draws: DrawList
    occluded_mask: torch.Tensor   # (P,) pairs deferred to phase 2
    stats: dict


def cull_pairs(pools, instances, frustum_planes: torch.Tensor, proj_scale,
               capacity: int, hzb: Optional[HZBPyramid] = None,
               hzb_tw_to_clip: Optional[torch.Tensor] = None,
               lod_threshold: float = 1.0, enable_cone: bool = True,
               extra_mask: Optional[torch.Tensor] = None,
               masked=None, active: Optional[ActivePairs] = None
               ) -> CullResult:
    """Full meshlet cull -> compacted draw list + occlusion remainder.
    `masked`: None = opaque+masked (never blend), False = opaque only,
    True = alpha-masked only, "blend" = blend only (pipeline_filter)."""
    pv = active if active is not None else pools
    od = gather_pair_objects(pv, instances)
    c, r = pair_spheres_tw(pv, instances, od)
    vis = pv.pair_valid & frustum_visible(c, r, frustum_planes) & od.valid
    if extra_mask is not None:
        vis = vis & extra_mask
    if masked is None:
        vis = vis & ~od.blend
    elif masked == "blend":
        vis = vis & od.blend
    elif masked:
        vis = vis & od.masked & ~od.blend
    else:
        vis = vis & ~od.masked & ~od.blend
    vis = vis & lod_cut_visible(pv, instances, proj_scale, lod_threshold, od)
    if enable_cone:
        vis = vis & cone_visible(pv, instances, c, od)
    occluded = torch.zeros_like(vis)
    if hzb is not None:
        unoccluded = occlusion_test_spheres(hzb, c, r, hzb_tw_to_clip)
        occluded = vis & ~unoccluded
        vis = vis & unoccluded
    draws = compact_draws(vis, pv, capacity)
    stats = {"culled_visible": vis.to(torch.int32).sum(),
             "culled_occluded": occluded.to(torch.int32).sum(),
             "draw_overflow": draws.overflow}
    return CullResult(draws=draws, occluded_mask=occluded, stats=stats)
