"""Closest-hit rays over the scene's BVH (port of chord_tpu/ops/rt.py).

The BVH is built on the host over world-space (translated-world) leaves:
one bounding sphere per instance (granularity "object", what bench.py's
`all` rung builds), per LOD-root meshlet (granularity "meshlet",
MeshletRenderer's default) or per root-cut triangle (granularity
"triangle", the viewer's --rt-exact: the leaf spheres only prune, the
leaf test is the exact ray-triangle test on Baldwin-Weber planes), by the
shared native builder (native/nanite.cpp chord_bvh_build;
`build_bvh_numpy` is the numpy oracle), flattened in DFS pre-order so a
node's subtree count is a skip pointer. Hits shade from a per-leaf mean
albedo with the sun and an ambient term (`shade_hits`; the triangle
leaves carry their true geometric normal), enough for the GI probe rays,
RTAO, DDGI's probe rays and the specular fallback after SSR to see
geometry the screen does not hold.

`trace` dispatches like chord_tpu: a sphere BVH of up to DENSE_LEAF_LIMIT
leaves tests every ray against every leaf in 512-leaf chunks
(`trace_dense`: two (R,3) @ (3,512) products a chunk), a triangle BVH of
up to DENSE_TRI_LIMIT triangles every ray against every triangle
(`trace_dense_tri`: six products a chunk); above them, the lock-step
skip-pointer scan (`trace_bvh`). Every 3-term dot of these tests, the
products included, is summed (p0 + p1) + p2 and every root rounded to
nearest, as chord_tpu's compiled tests are without FMA: a ray's hit is
then the same on the card, the CPU and chord_tpu. None of these has a
Pallas kernel in chord_tpu, and none has a kernel here.

Hit distances are float32; a miss has leaf -1 and t = t_max.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import colorspace
from ._util import dot3, recip, sqrt_rn


class SceneBVH(NamedTuple):
    """Flattened BVH + leaf shading table (tensors on one device)."""

    node_sphere: torch.Tensor    # (M,4) xyzr
    node_count: torch.Tensor     # (M,) i32 subtree size (skip pointer)
    node_leaf: torch.Tensor      # (M,) i32 leaf element id or -1
    leaf_albedo: torch.Tensor    # (N,3) AP1 mean albedo per leaf
    leaf_emissive: torch.Tensor  # (N,3) AP1
    leaf_sphere: Optional[torch.Tensor] = None   # (N,4) the dense path's
    # triangle-exact leaves (granularity "triangle"): Baldwin-Weber planes
    # [n | dn | n1 | d1 | n2 | d2] per triangle (t = -(o.n + dn)/(d.n),
    # barycentrics affine in the hit point) and the unit geometric normal
    tri_planes: Optional[torch.Tensor] = None    # (N,12) f32
    leaf_normal: Optional[torch.Tensor] = None   # (N,3) f32


def build_bvh_numpy(spheres: np.ndarray) -> dict:
    """numpy version of the native chord_bvh_build (the same DFS
    pre-order flatten and skip counts: median splits on x, then y, then
    z, so up to 8 children a node) -> {sphere (M,4), count (M,), leaf
    (M,)}; the test oracle of the native builder."""
    spheres = np.asarray(spheres, np.float32).reshape(-1, 4)
    out_sphere, out_count, out_leaf = [], [], []

    def bound(ids):
        c = spheres[ids, :3].mean(0)
        r = (np.linalg.norm(spheres[ids, :3] - c, axis=1) +
             spheres[ids, 3]).max()
        return np.array([c[0], c[1], c[2], r], np.float32)

    def split(a, axis):
        o = a[np.argsort(spheres[a, axis], kind="stable")]
        m = len(o) // 2
        return o[:m], o[m:]

    def rec(ids):
        idx = len(out_sphere)
        out_sphere.append(bound(ids))
        out_count.append(1)
        out_leaf.append(int(ids[0]) if len(ids) == 1 else -1)
        if len(ids) == 1:
            return 1
        total = 1
        for hx in split(np.asarray(ids), 0):
            if len(hx) == 0:
                continue
            for q in split(hx, 1):
                if len(q) == 0:
                    continue
                for o in split(q, 2):
                    if len(o) == 0:
                        continue
                    total += rec(list(o))
        out_count[idx] = total
        return total

    rec(list(range(len(spheres))))
    return {"sphere": np.stack(out_sphere),
            "count": np.asarray(out_count, np.int32),
            "leaf": np.asarray(out_leaf, np.int32)}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tri_planes_np(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray
                   ) -> np.ndarray:
    """Baldwin-Weber planes (N,12) f32 of a triangle soup (corner v0,
    edges e1, e2): [n | dn | n1 | d1 | n2 | d2], t = -(o.n + dn)/(d.n),
    u = p.n1 + d1, v = p.n2 + d2; a hit iff u >= 0, v >= 0, u + v <= 1
    (two-sided). Computed in the inputs' precision, rounded once."""
    n = np.cross(e1, e2)
    denom = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
    n1 = np.cross(e2, n) / denom
    n2 = np.cross(n, e1) / denom
    dn = -(n * v0).sum(-1, keepdims=True)
    d1 = -(n1 * v0).sum(-1, keepdims=True)
    d2 = -(n2 * v0).sum(-1, keepdims=True)
    return np.concatenate([n, dn, n1, d1, n2, d2], -1).astype(np.float32)


def _root_pairs(pools, coarse_only: bool) -> np.ndarray:
    """Ids of the valid pairs whose meshlet is a LOD root (parent error
    +inf; every valid pair without `coarse_only`, or when none is a
    root)."""
    valid = _host(pools.pair_valid)
    perr = _host(pools.meshlet_parent_error)[_host(pools.pair_meshlet)]
    keep = valid & (perr > 1e30) if coarse_only else valid
    ids = np.nonzero(keep)[0]
    return ids if len(ids) else np.nonzero(valid)[0]


def _triangle_leaves(pools, instances, coarse_only: bool):
    """The root-cut meshlets' triangles in translated world (float64 until
    the tables are rounded), degenerates (twice the area <= 1e-12) dropped
    -> (bounding spheres (N,4) f32 about the centroid, planes (N,12),
    unit normals (N,3) f32, instance ids (N,))."""
    ids = _root_pairs(pools, coarse_only)
    m = _host(pools.pair_meshlet)[ids]
    obj = _host(pools.pair_object)[ids]
    tri = _host(pools.tri_indices).reshape(-1, 128, 3)[m]
    cnt = _host(pools.meshlet_tri_count)[m]
    tmask = np.arange(128)[None, :] < cnt[:, None]           # (K,128)
    v = _host(pools.positions)[tri]                          # (K,128,3,3)
    o2w = _host(instances.object_to_tw)[obj]                 # (K,4,4)
    vh = np.concatenate([v, np.ones(v.shape[:3] + (1,))], -1)
    vw = np.einsum("ktcj,kjl->ktcl", vh, o2w)[..., :3]
    inst = np.broadcast_to(obj[:, None], tmask.shape)[tmask]
    v0 = vw[:, :, 0][tmask]
    e1 = (vw[:, :, 1] - vw[:, :, 0])[tmask]
    e2 = (vw[:, :, 2] - vw[:, :, 0])[tmask]
    nrm = np.cross(e1, e2)
    area2 = np.linalg.norm(nrm, axis=1)
    ok = area2 > 1e-12
    v0, e1, e2, nrm, inst, area2 = (v0[ok], e1[ok], e2[ok], nrm[ok],
                                    inst[ok], area2[ok])
    center = v0 + (e1 + e2) / 3.0
    rad = np.maximum(
        np.linalg.norm(v0 - center, axis=1),
        np.maximum(np.linalg.norm(v0 + e1 - center, axis=1),
                   np.linalg.norm(v0 + e2 - center, axis=1)))
    world = np.concatenate([center, rad[:, None]], 1).astype(np.float32)
    return (world, _tri_planes_np(v0, e1, e2),
            (nrm / area2[:, None]).astype(np.float32), inst)


def build_scene_bvh(pools, instances, coarse_only: bool = True,
                    granularity: str = "meshlet") -> SceneBVH:
    """BVH over the scene in translated world, built on the host, on the
    pools' device.

    granularity="object": one sphere per valid instance (its
    object_sphere_tw). granularity="meshlet": the LOD-root meshlets'
    spheres of every valid pair (parent error +inf; every valid pair
    without `coarse_only`), moved to world by the instance's
    object-to-translated-world matrix and scaled by its largest axis.
    granularity="triangle": every non-degenerate triangle of those
    meshlets, moved to world (float64 on the host), a leaf each with its
    bounding sphere, Baldwin-Weber planes and unit normal.
    Leaf albedo is the material's base colour in AP1, leaf emission its
    emissive colour. The native builder runs when the shared library
    loads, else build_bvh_numpy (as chord_tpu); `build_scene_bvh.builder`
    names the one the last call used."""
    if granularity not in ("object", "meshlet", "triangle"):
        raise ValueError(f"unknown BVH granularity {granularity!r}")
    dev = pools.positions.device
    tri = {}
    if granularity == "object":
        ids = np.nonzero(_host(instances.object_valid))[0]
        world = _host(instances.object_sphere_tw)[ids].astype(np.float32)
        obj = ids
    elif granularity == "triangle":
        world, planes, normal, obj = _triangle_leaves(pools, instances,
                                                      coarse_only)
        tri = dict(tri_planes=planes, leaf_normal=normal)
    else:
        ids = _root_pairs(pools, coarse_only)
        m = _host(pools.pair_meshlet)[ids]
        obj = _host(pools.pair_object)[ids]
        sph = _host(pools.meshlet_sphere)[m]                     # (N,4)
        o2w = _host(instances.object_to_tw)[obj]                 # (N,4,4)
        c = np.concatenate([sph[:, :3], np.ones((len(ids), 1))], 1)
        cw = np.einsum("nj,njk->nk", c, o2w)[:, :3]
        scale = np.linalg.norm(o2w[:, :3, :3], axis=2).max(1)
        world = np.concatenate([cw, (sph[:, 3] * scale)[:, None]],
                               1).astype(np.float32)

    from ..native import available, bvh_build
    if available():
        bvh = bvh_build(world)
        build_scene_bvh.builder = "native"
    else:
        bvh = build_bvh_numpy(world)
        build_scene_bvh.builder = "numpy"
    mat = _host(instances.object_material)[obj]
    albedo = colorspace.srgb_to_acescg(
        pools.mat_base_color.detach().cpu()[torch.from_numpy(mat).long(),
                                            :3])
    emissive = _host(pools.mat_emissive)[mat][:, :3]
    as_dev = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
    return SceneBVH(node_sphere=as_dev(bvh["sphere"]),
                    node_count=as_dev(bvh["count"]),
                    node_leaf=as_dev(bvh["leaf"]),
                    leaf_albedo=albedo.to(dev), leaf_emissive=as_dev(emissive),
                    leaf_sphere=as_dev(world),
                    **{k: as_dev(v) for k, v in tri.items()})


build_scene_bvh.builder = None


def _ray_sphere(o: torch.Tensor, d: torch.Tensor, sph: torch.Tensor):
    """Entry distance of ray o + t*d into sphere (...,4) -> (hit, t_entry);
    an origin inside gives t_entry = 0. Each dot is summed (p0 + p1) + p2
    and the root rounded to nearest (_util.sqrt_rn), as chord_tpu's
    compiled _ray_sphere rounds them, on every device."""
    oc = o - sph[..., :3]
    b = dot3(oc, d)
    c2 = dot3(oc, oc) - sph[..., 3] * sph[..., 3]
    disc = b * b - c2
    sq = sqrt_rn(torch.clamp_min(disc, 0.0))
    t_entry = torch.where(c2 < 0.0, torch.zeros((), device=o.device),
                          -b - sq)
    return (disc >= 0.0) & ((-b + sq) > 0.0), t_entry


# chord_tpu's crossovers of its dense and scan paths: the object and
# meshlet proxy sets of the bench scenes stay far below the first; the
# triangle test is six (R,3) @ (3,512) products a chunk to the sphere
# test's two, so its limit is lower
DENSE_LEAF_LIMIT = 16384
DENSE_TRI_LIMIT = 8192
# trace_bvh reads its loop condition (a host synchronisation) every this
# many steps, and on the card replays them as one CUDA graph; steps after
# every ray has finished change nothing
_SCAN_CHECK = 8


def trace(origins: torch.Tensor, dirs: torch.Tensor, bvh: SceneBVH,
          t_max: float = 1e9, max_steps: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest hit. origins/dirs (...,3) -> (t (...,), leaf (...,) i32,
    -1 = miss). A triangle BVH takes the dense triangle path up to
    DENSE_TRI_LIMIT triangles, a sphere BVH the dense path up to
    DENSE_LEAF_LIMIT leaf spheres (both with no step budget); the BVH scan
    otherwise. `trace.calls` counts the calls, `trace.dense` those of them
    on a dense path, `trace.rays` the rays traced."""
    trace.calls += 1
    trace.rays += origins.numel() // 3
    if bvh.tri_planes is not None:
        if bvh.tri_planes.shape[0] <= DENSE_TRI_LIMIT and max_steps is None:
            trace.dense += 1
            return trace_dense_tri(origins, dirs, bvh.tri_planes, t_max)
        return trace_bvh(origins, dirs, bvh, t_max, max_steps)
    if (bvh.leaf_sphere is not None and
            bvh.leaf_sphere.shape[0] <= DENSE_LEAF_LIMIT and
            max_steps is None):
        trace.dense += 1
        return trace_dense(origins, dirs, bvh.leaf_sphere, t_max)
    return trace_bvh(origins, dirs, bvh, t_max, max_steps)


trace.calls = trace.dense = trace.rays = 0


def trace_dense_tri(origins: torch.Tensor, dirs: torch.Tensor,
                    planes: torch.Tensor, t_max: float = 1e9,
                    chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every ray against every triangle's Baldwin-Weber planes, `chunk`
    triangles at a time, keeping the running closest hit (the first
    triangle of a chunk on a tie, the earlier chunk across chunks). Each
    per-ray term is a dot of a ray with a chunk's plane, broadcast to
    (R,chunk) and summed (p0 + p1) + p2 as chord_tpu's compiled
    (R,3) @ (3,chunk) products are (a BLAS matmul sums otherwise), and
    u = (o.n1) + t (d.n1) + d1 in that association. Padding rows are all
    zero: d.n = 0, a miss."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    dev = o.device
    pad = (-planes.shape[0]) % chunk
    if pad:
        planes = torch.cat([planes, torch.zeros((pad, 12),
                                                dtype=planes.dtype,
                                                device=dev)])
    o3, d3 = o[:, None, :], d[:, None, :]
    one = torch.ones((), device=dev)
    inf = torch.full((), float("inf"), device=dev)
    t_best = torch.full((o.shape[0],), t_max, dtype=torch.float32, device=dev)
    leaf_best = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    for base in range(0, planes.shape[0], chunk):
        pc = planes[base:base + chunk]
        nrm, n1, n2 = pc[None, :, 0:3], pc[None, :, 4:7], pc[None, :, 8:11]
        den = dot3(d3, nrm)                               # (R,chunk)
        num = -(dot3(o3, nrm) + pc[:, 3][None, :])
        safe = torch.abs(den) > 1e-12
        t = num / torch.where(safe, den, one)
        u = (dot3(o3, n1) + t * dot3(d3, n1)) + pc[:, 7][None, :]
        v = (dot3(o3, n2) + t * dot3(d3, n2)) + pc[:, 11][None, :]
        hit = safe & (t > 1e-4) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        t_hit = torch.where(hit, t, inf)
        j = torch.argmin(t_hit, dim=1)
        t_c = torch.gather(t_hit, 1, j[:, None])[:, 0]
        take = t_c < t_best
        t_best = torch.where(take, t_c, t_best)
        leaf_best = torch.where(take, (j + base).to(torch.int32), leaf_best)
    return t_best.reshape(shape), leaf_best.reshape(shape)


def trace_dense(origins: torch.Tensor, dirs: torch.Tensor,
                spheres: torch.Tensor, t_max: float = 1e9,
                chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every ray against every leaf sphere, `chunk` spheres at a time
    (the (R, chunk) planes stay bounded), keeping the running closest
    hit. (o-c)·d and |o-c|^2 expand into per-ray terms and the d @ c^T,
    o @ c^T products. Every 3-term dot is summed as chord_tpu's compiled
    dot and sum are ((p0 + p1) + p2, one rounding an operation) on every
    device: the expansion cancels on large spheres (t off by ~1e-5 at
    r = 12), so another order (a BLAS matmul's) moves t by far more than
    an ulp and flips the closest of two nearly equal hits; the root is
    rounded to nearest on every device (_util.sqrt_rn). Padding spheres
    have radius -1 and never hit."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    dev = o.device
    pad = (-spheres.shape[0]) % chunk
    if pad:
        poison = torch.zeros((pad, 4), dtype=spheres.dtype, device=dev)
        poison[:, 3] = -1.0
        spheres = torch.cat([spheres, poison])
    od = dot3(o, d)[:, None]                              # (R,1)
    oo = dot3(o, o)[:, None]                              # (R,1)
    zero = torch.zeros((), device=dev)
    inf = torch.full((), float("inf"), device=dev)
    t_best = torch.full((o.shape[0],), t_max, dtype=torch.float32, device=dev)
    leaf_best = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    for base in range(0, spheres.shape[0], chunk):
        sc = spheres[base:base + chunk]
        c, rad = sc[:, :3], sc[:, 3]
        b = od - dot3(d[:, None, :], c[None])             # (o-c)·d
        c2 = (oo - 2.0 * dot3(o[:, None, :], c[None]) +
              dot3(c, c)[None, :] - (rad * rad)[None, :])
        disc = b * b - c2
        sq = sqrt_rn(torch.clamp_min(disc, 0.0))
        t_entry = torch.where(c2 < 0.0, zero, -b - sq)
        hit = ((disc >= 0.0) & ((-b + sq) > 0.0) & (t_entry > 1e-4) &
               (rad[None, :] > 0.0))
        t_hit = torch.where(hit, t_entry, inf)
        j = torch.argmin(t_hit, dim=1)
        t_c = torch.gather(t_hit, 1, j[:, None])[:, 0]
        take = t_c < t_best
        t_best = torch.where(take, t_c, t_best)
        leaf_best = torch.where(take, (j + base).to(torch.int32), leaf_best)
    return t_best.reshape(shape), leaf_best.reshape(shape)


def _scan_step(o: torch.Tensor, d: torch.Tensor, bvh: SceneBVH, m: int,
               i: torch.Tensor, t_best: torch.Tensor,
               leaf_best: torch.Tensor) -> None:
    """One lock-step of trace_bvh, updating the ray state (cursor, best
    t, best leaf) in place."""
    dev = o.device
    ii = torch.clamp_max(i, m - 1).long()
    cnt = bvh.node_count[ii]
    lf = bvh.node_leaf[ii]
    active = i < m
    hit, t_in = _ray_sphere(o, d, bvh.node_sphere[ii])
    useful = hit & (t_in < t_best) & active
    is_leaf = lf >= 0
    if bvh.tri_planes is not None:
        # the node sphere only prunes; the leaf test is the triangle
        pc = bvh.tri_planes[torch.clamp_min(lf, 0).long()]       # (R,12)
        den = dot3(d, pc[:, 0:3])
        safe = torch.abs(den) > 1e-12
        t_leaf = -(dot3(o, pc[:, 0:3]) + pc[:, 3]) / \
            torch.where(safe, den, torch.ones((), device=dev))
        p = o + t_leaf[:, None] * d
        u = dot3(p, pc[:, 4:7]) + pc[:, 7]
        v = dot3(p, pc[:, 8:11]) + pc[:, 11]
        take = (useful & is_leaf & safe & (t_leaf > 1e-4) & (u >= 0.0) &
                (v >= 0.0) & (u + v <= 1.0) & (t_leaf < t_best))
    else:
        take = useful & is_leaf & (t_in > 1e-4)
        t_leaf = t_in
    step_i = torch.where(useful & ~is_leaf,
                         torch.ones((), dtype=torch.int32, device=dev), cnt)
    t_best.copy_(torch.where(take, t_leaf, t_best))
    leaf_best.copy_(torch.where(take, lf, leaf_best))
    i.copy_(torch.where(active, i + step_i, i))


def _scan_graph(block, state):
    """A CUDA graph of `block` (_SCAN_CHECK scan steps on `state`), or
    None off the card. The block first runs once on a copy of the state,
    so every kernel it launches is loaded before the capture."""
    if not state[0].is_cuda:
        return None
    block([x.clone() for x in state])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        block(state)
    return graph


def trace_bvh(origins: torch.Tensor, dirs: torch.Tensor, bvh: SceneBVH,
              t_max: float = 1e9, max_steps: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stackless skip-pointer scan, lock-step over rays: each ray keeps a
    cursor i; a missed node, or one no nearer than the ray's best hit,
    skips its subtree (i += count[i]), a hit internal node descends
    (i += 1), a hit leaf updates the closest hit: its sphere entry, or on
    a triangle BVH its triangle's exact hit (p = o + t d; u = p.n1 + d1,
    in that association), nearer than the best. At most `max_steps` steps
    (default min(nodes, 384), 1536 on a triangle BVH): a ray still
    scanning then keeps what it found, so an unfinished ray may miss, as
    in chord_tpu. The loop condition is read (a host synchronisation)
    every _SCAN_CHECK steps; on the card each such block of steps is one
    CUDA graph of the same operations, captured per call, so the host
    issues the ~70 small operations of a step once and not every step.
    The module's `scan_steps` counts the steps run."""
    global scan_steps
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3).contiguous()
    d = dirs.reshape(-1, 3).contiguous()
    dev = o.device
    m = int(bvh.node_sphere.shape[0])
    if max_steps is None:
        max_steps = min(m, 1536 if bvh.tri_planes is not None else 384)
    state = (torch.zeros(o.shape[0], dtype=torch.int32, device=dev),
             torch.full((o.shape[0],), t_max, dtype=torch.float32,
                        device=dev),
             torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev))

    def block(st, k=_SCAN_CHECK):
        for _ in range(k):
            _scan_step(o, d, bvh, m, *st)

    graph = (_scan_graph(block, state) if max_steps > _SCAN_CHECK
             else None)
    done = 0
    while done < max_steps and bool((state[0] < m).any()):
        k = min(_SCAN_CHECK, max_steps - done)
        if graph is not None and k == _SCAN_CHECK:
            graph.replay()
        else:
            block(state, k)
        done += k
    scan_steps += done
    return state[1].reshape(shape), state[2].reshape(shape)


scan_steps = 0      # trace_bvh's lock-step steps run, over all calls


def trace_brute_numpy(origins: np.ndarray, dirs: np.ndarray,
                      spheres: np.ndarray):
    """O(R*N) closest-hit oracle over the raw leaf spheres -> (t, leaf);
    a miss has t = 1e9 and leaf -1. Computes in the inputs' precision."""
    o = origins.reshape(-1, 1, 3)
    d = dirs.reshape(-1, 1, 3)
    s = spheres.reshape(1, -1, 4)
    oc = o - s[..., :3]
    b = (oc * d).sum(-1)
    c2 = (oc * oc).sum(-1) - s[..., 3] ** 2
    disc = b * b - c2
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t_entry = np.where(c2 < 0.0, 0.0, t0)
    hit = (disc >= 0.0) & (t1 > 0.0) & (t_entry > 1e-4)
    t = np.where(hit, t_entry, 1e9)
    best = t.argmin(1)
    tb = t[np.arange(len(best)), best]
    leaf = np.where(tb < 1e9, best, -1)
    return tb, leaf.astype(np.int32)


def trace_brute_tri_numpy(origins: np.ndarray, dirs: np.ndarray,
                          v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """O(R*N) Moller-Trumbore closest-hit oracle over raw triangles
    (two-sided), independent of the Baldwin-Weber planes -> (t, leaf); a
    miss has t = 1e9 and leaf -1. Computes in the inputs' precision."""
    o = origins.reshape(-1, 1, 3)
    d = dirs.reshape(-1, 1, 3)
    v0 = v0.reshape(1, -1, 3)
    e1 = e1.reshape(1, -1, 3)
    e2 = e2.reshape(1, -1, 3)
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    safe = np.abs(det) > 1e-12
    inv = 1.0 / np.where(safe, det, 1.0)
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    hit = safe & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    t = np.where(hit, t, 1e9)
    best = t.argmin(1)
    tb = t[np.arange(len(best)), best]
    leaf = np.where(tb < 1e9, best, -1)
    return tb, leaf.astype(np.int32)


def shade_hits(t: torch.Tensor, leaf: torch.Tensor, origins: torch.Tensor,
               dirs: torch.Tensor, bvh: SceneBVH,
               sun_direction: torch.Tensor, sun_radiance: torch.Tensor,
               ambient: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate hit radiance: the leaf's mean albedo x (sun N.L / pi +
    ambient) + its emission, with the normal facing the ray (-dir; a
    triangle-exact BVH's geometric normal, flipped toward the origin) ->
    (radiance (...,3), confidence (...,): 1 on a hit, 0 on a miss)."""
    ok = leaf >= 0
    lf = torch.clamp_min(leaf, 0).long()
    alb = bvh.leaf_albedo[lf]
    emis = bvh.leaf_emissive[lf]
    if bvh.leaf_normal is not None:
        gn = bvh.leaf_normal[lf]
        n = gn * -torch.sign(dot3(gn, dirs)[..., None] + 1e-12)
    else:
        n = -dirs
    ndl = torch.clamp(dot3(n, sun_direction), 0.0, 1.0)
    rad = alb * (sun_radiance * ndl[..., None] * recip(np.pi) + ambient) + \
        emis
    return (torch.where(ok[..., None], rad, torch.zeros((), device=t.device)),
            ok.to(torch.float32))
