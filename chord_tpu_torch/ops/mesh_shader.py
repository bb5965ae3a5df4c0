"""Mesh shader: fused draw expansion + triangle setup (port of
chord_tpu/ops/mesh_shader.py; reference mesh_raster.hlsl:51-120).

`mesh_shader_setup` turns a compacted DrawList into the raster's
TriangleSetup with kernel K2:

    mesh_shader   CUDA kernel csrc/mesh_shader.cu (CUDA tensors) or
                  mesh_shader_plain (CPU tensors)

Replaces chord_tpu/ops/mesh_shader.py::_mesh_shader_kernel (:58). One
step per draw slot: transform the meshlet's corners by the draw's
local->clip matrix, do the homogeneous setup (cofactors, depth plane, 5
attribute planes, back-face / two-sided cull, pixel bbox, validity), then
sort the window's triangles by (invalid, y/8, x/32) with key
key*256+lane: the rank of each lane among the 128 keys is its output row,
the permutation chord_tpu applies with one-hot matmuls. The payload
((slot+payload_base+1)*128)+lane uses the pre-sort lane. Slack slots
(slot >= count) write poison (lambda-c lanes 10-12 = -1.0f), and one
poison window is appended for the raster's slack pairs.

Coefficient lanes (32 per triangle, int32 bit patterns):
    0-4    l0a l1a l2a Na Da      5-9 the b coefficients   10-14 the c's
    15     payload (slot+1):25 | tri:7
    16-30  attribute numerator planes: 5 attrs x (a,b,c)   31 pad
Meta rows (5, cap*128) f32: valid, ix0, iy0, ix1, iy1 (sorted like coef).
chord_tpu pads the coefficient block to 128 lanes for the TPU's DMA;
here it is 32 wide.
"""

from __future__ import annotations

import torch

from . import _cuda
from ._util import bits_i32
from .raster import COEF_ROWS, WINDOW, TriangleSetup, _sub_bounds

META_ROWS = 5
EPS_W = 1e-6


def matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(...,4,4) @ (4,4) with each dot summed left to right in f32."""
    return (a[..., :, 0:1] * b[0] + a[..., :, 1:2] * b[1] +
            a[..., :, 2:3] * b[2] + a[..., :, 3:4] * b[3])


def mesh_shader_inputs(draws, pools, instances, tw_to_clip: torch.Tensor,
                       capacity: int):
    """DrawList -> the K2 inputs (dm, tcnt, count, mats): per-slot meshlet
    id (slack -> the poison window), triangle count, the live count, and
    per-draw [local->clip (16) | normal matrix (9) | two_sided] rows."""
    cap = capacity
    dev = tw_to_clip.device
    n_meshlets = pools.meshlet_sphere.shape[0]
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    active = slot < draws.count
    dm = torch.where(active, draws.meshlet_id,
                     torch.tensor(n_meshlets, dtype=torch.int32, device=dev))
    obj = torch.where(active, draws.object_id,
                      torch.zeros((), dtype=torch.int32, device=dev)).long()
    l2c = matmul4(instances.object_to_tw[obj], tw_to_clip)       # (cap,4,4)
    tcnt = torch.where(active, pools.meshlet_tri_count[
        torch.clamp(dm, max=n_meshlets - 1).long()],
        torch.zeros((), dtype=torch.int32, device=dev))
    mats = torch.cat([l2c.reshape(cap, 16),
                      instances.object_normal_mat[obj].reshape(cap, 9),
                      instances.object_two_sided[obj][:, None]],
                     dim=1).contiguous()
    return (dm.contiguous(), tcnt.to(torch.int32).contiguous(),
            draws.count.reshape(1).to(torch.int32).contiguous(), mats)


def mesh_shader_setup(draws, pools, instances, tw_to_clip: torch.Tensor,
                      capacity: int, width: int, height: int,
                      payload_base: int = 0, backface_cull: bool = True,
                      sort_tris: bool = True, sub_s: int = 4
                      ) -> TriangleSetup:
    """Run K2 -> TriangleSetup for bin_windows / raster_queue."""
    dm, tcnt, count, mats = mesh_shader_inputs(draws, pools, instances,
                                               tw_to_clip, capacity)
    coefT, meta = mesh_shader(dm, tcnt, count, mats, pools.mv_posT,
                              pools.mv_attrT, width, height, payload_base,
                              backface_cull, sort_tris)
    return setup_from_meta(coefT, meta, capacity, sub_s)


def setup_from_meta(coefT: torch.Tensor, meta: torch.Tensor, cap: int,
                    sub_s: int) -> TriangleSetup:
    """Window bbox / validity / sub-bounds reductions over K2's meta rows."""
    valid = (meta[0] > 0.5).reshape(cap, WINDOW)
    f = lambda r: meta[r].reshape(cap, WINDOW)
    big, neg = torch.tensor(1e9, device=meta.device), torch.tensor(
        -1.0, device=meta.device)
    wx0 = torch.where(valid, f(1), big).amin(dim=1).to(torch.int32)
    wy0 = torch.where(valid, f(2), big).amin(dim=1).to(torch.int32)
    wx1 = torch.where(valid, f(3), neg).amax(dim=1).to(torch.int32)
    wy1 = torch.where(valid, f(4), neg).amax(dim=1).to(torch.int32)
    vflat = valid.reshape(-1)
    iv = lambda r, pois: torch.where(
        vflat, meta[r].to(torch.int32),
        torch.tensor(pois, dtype=torch.int32, device=meta.device))
    sub_bounds = _sub_bounds(iv(2, 1 << 29), iv(4, -1), iv(1, 1 << 29),
                             iv(3, -1), cap, sub_s)
    return TriangleSetup(coefT=coefT,
                         window_bbox=torch.stack([wx0, wy0, wx1, wy1], 0),
                         window_valid=valid.any(dim=1), valid=vflat,
                         sub_bounds=sub_bounds)


def _poison_row(dev) -> torch.Tensor:
    row = torch.zeros(COEF_ROWS, dtype=torch.float32, device=dev)
    row[10:13] = -1.0
    return bits_i32(row)


# --- K2: the plain version --------------------------------------------------

def mesh_shader_plain(dm, tcnt, count, mats, posT, attrT, width: int,
                      height: int, payload_base: int = 0,
                      backface_cull: bool = True, sort_tris: bool = True):
    """Plain PyTorch version of kernel K2 -> (coefT ((cap+1)*128, 32) i32,
    meta (5, cap*128) f32). Same arithmetic, in the same order, as the
    kernel and as chord_tpu's Pallas kernel."""
    cap = dm.shape[0]
    dev = mats.device
    lane = torch.arange(WINDOW, dtype=torch.int32, device=dev)
    cols = dm.long()[:, None] * WINDOW + lane.long()[None, :]
    P = posT[:, cols]                                        # (12,cap,128)
    A = attrT[:, cols]                                       # (16,cap,128)
    m = [[mats[:, r * 4 + c][:, None] for c in range(4)] for r in range(4)]
    nm = [[mats[:, 16 + r * 3 + c][:, None] for c in range(3)]
          for r in range(3)]
    fw, fh = float(width), float(height)

    def corner(k):
        x, y, z = P[4 * k], P[4 * k + 1], P[4 * k + 2]
        cx = x * m[0][0] + y * m[1][0] + z * m[2][0] + m[3][0]
        cy = x * m[0][1] + y * m[1][1] + z * m[2][1] + m[3][1]
        cz = x * m[0][2] + y * m[1][2] + z * m[2][2] + m[3][2]
        cw = x * m[0][3] + y * m[1][3] + z * m[2][3] + m[3][3]
        X = (cx * 0.5 + cw * 0.5) * fw
        Y = (cw * 0.5 - cy * 0.5) * fh
        s = 1.0 / torch.maximum(torch.maximum(X.abs(), Y.abs()),
                                torch.clamp_min(cw.abs(), EPS_W))
        return X * s, Y * s, cw * s, cz * s, cw

    X0, Y0, w0, z0, rw0 = corner(0)
    X1, Y1, w1, z1, rw1 = corner(1)
    X2, Y2, w2, z2, rw2 = corner(2)

    def cross3(ax, ay, aw, bx, by, bw):
        return (ay * bw - aw * by, aw * bx - ax * bw, ax * by - ay * bx)

    l0 = cross3(X1, Y1, w1, X2, Y2, w2)
    l1 = cross3(X2, Y2, w2, X0, Y0, w0)
    l2 = cross3(X0, Y0, w0, X1, Y1, w1)
    det = X0 * l0[0] + Y0 * l0[1] + w0 * l0[2]
    flip = torch.where(det < 0.0, -1.0, 1.0)
    if backface_cull:
        two_sided = mats[:, 25][:, None] > 0.5
        front = (det < 0.0) | (two_sided & (det != 0.0))
    else:
        front = det != 0.0
    l0 = tuple(flip * v for v in l0)
    l1 = tuple(flip * v for v in l1)
    l2 = tuple(flip * v for v in l2)
    N = tuple(l0[k] * z0 + l1[k] * z1 + l2[k] * z2 for k in range(3))
    D = tuple(l0[k] * w0 + l1[k] * w1 + l2[k] * w2 for k in range(3))

    def center(f):
        return (f[0], f[1], f[2] + 0.5 * f[0] + 0.5 * f[1])

    l0, l1, l2, N, D = center(l0), center(l1), center(l2), center(N), \
        center(D)

    one = torch.ones((), device=dev)
    all_front = (rw0 > EPS_W) & (rw1 > EPS_W) & (rw2 > EPS_W)
    iw0 = 1.0 / torch.where(rw0 > EPS_W, w0, one)
    iw1 = 1.0 / torch.where(rw1 > EPS_W, w1, one)
    iw2 = 1.0 / torch.where(rw2 > EPS_W, w2, one)
    sx0, sx1, sx2 = X0 * iw0, X1 * iw1, X2 * iw2
    sy0, sy1, sy2 = Y0 * iw0, Y1 * iw1, Y2 * iw2
    mn = lambda a, b, c: torch.minimum(torch.minimum(a, b), c)
    mx = lambda a, b, c: torch.maximum(torch.maximum(a, b), c)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    xmin = torch.where(all_front, mn(sx0, sx1, sx2), t(0.0))
    xmax = torch.where(all_front, mx(sx0, sx1, sx2), t(fw))
    ymin = torch.where(all_front, mn(sy0, sy1, sy2), t(0.0))
    ymax = torch.where(all_front, mx(sy0, sy1, sy2), t(fh))
    ix0 = torch.clamp(torch.floor(xmin), 0.0, fw - 1)
    ix1 = torch.clamp(torch.ceil(xmax), 0.0, fw - 1)
    iy0 = torch.clamp(torch.floor(ymin), 0.0, fh - 1)
    iy1 = torch.clamp(torch.ceil(ymax), 0.0, fh - 1)
    onscreen = (xmax >= 0.0) & (xmin < fw) & (ymax >= 0.0) & (ymin < fh)
    covers_center = (~all_front) | (
        (torch.ceil(xmin - 0.5) <= torch.floor(xmax - 0.5)) &
        (torch.ceil(ymin - 0.5) <= torch.floor(ymax - 0.5)))
    any_front = (rw0 > EPS_W) | (rw1 > EPS_W) | (rw2 > EPS_W)
    tri_ok = lane[None, :] < tcnt[:, None]
    valid = (tri_ok & front & (det != 0.0) & onscreen & covers_center &
             any_front)
    slot = torch.arange(cap, dtype=torch.int32, device=dev)[:, None]
    payload = torch.where(valid, (slot + payload_base + 1) * WINDOW +
                          lane[None, :], torch.zeros((), dtype=torch.int32,
                                                     device=dev))

    def attr_corner(b):
        nx, ny, nz, u, v = (A[b + i] for i in range(5))
        return (nx * nm[0][0] + ny * nm[1][0] + nz * nm[2][0],
                nx * nm[0][1] + ny * nm[1][1] + nz * nm[2][1],
                nx * nm[0][2] + ny * nm[1][2] + nz * nm[2][2], u, v)

    a0, a1, a2 = attr_corner(0), attr_corner(5), attr_corner(10)
    validf = valid.to(torch.float32)
    poison_c = torch.where(valid, 0.0, -1.0)
    raster_rows = [l0[0], l1[0], l2[0], N[0], D[0],
                   l0[1], l1[1], l2[1], N[1], D[1],
                   l0[2], l1[2], l2[2], N[2], D[2]]
    rows = []
    for r in range(COEF_ROWS):
        if r < 10:
            rows.append(bits_i32(raster_rows[r] * validf))
        elif r < 15:
            rows.append(bits_i32(torch.where(valid, raster_rows[r], poison_c)))
        elif r == 15:
            rows.append(payload)
        elif r < 31:
            k, comp = (r - 16) // 3, (r - 16) % 3
            plane = (a0[k] * l0[comp] + a1[k] * l1[comp] + a2[k] * l2[comp])
            rows.append(bits_i32(plane * validf))
        else:
            rows.append(torch.zeros_like(payload))
    blk = torch.stack(rows, dim=0)                           # (32,cap,128)
    meta = torch.stack([validf,
                        torch.where(valid, ix0, t(1e9)),
                        torch.where(valid, iy0, t(1e9)),
                        torch.where(valid, ix1, t(-1.0)),
                        torch.where(valid, iy1, t(-1.0))], dim=0)

    if sort_tris:
        x_buckets = float(-(-width // 32))
        inv_bucket = (float(-(-height // 8)) + 1.0) * x_buckets
        key = torch.where(valid, torch.floor(iy0 * 0.125) * x_buckets +
                          torch.floor(ix0 * 0.03125), t(inv_bucket))
        keyj = key * 256.0 + lane[None, :].to(torch.float32)
        order = torch.argsort(keyj, dim=1)       # keys are distinct
        blk = torch.gather(blk, 2, order[None].expand_as(blk))
        meta = torch.gather(meta, 2, order[None].expand_as(meta))

    live = (slot < count.reshape(()))                         # (cap,1)
    coef = blk.permute(1, 2, 0)                               # (cap,128,32)
    poison = _poison_row(dev)
    coef = torch.where(live[:, :, None], coef, poison)
    meta = torch.where(live[None], meta, torch.zeros((), device=dev))
    coefT = torch.cat([coef.reshape(cap * WINDOW, COEF_ROWS),
                       poison[None].expand(WINDOW, COEF_ROWS)], dim=0)
    return coefT.contiguous(), meta.reshape(META_ROWS, cap * WINDOW)


# --- K2: the wrapper --------------------------------------------------------

def mesh_shader(dm, tcnt, count, mats, posT, attrT, width: int, height: int,
                payload_base: int = 0, backface_cull: bool = True,
                sort_tris: bool = True):
    """Kernel K2 -> (coefT ((cap+1)*128, 32) i32, meta (5, cap*128) f32).
    CPU tensors -> mesh_shader_plain; CUDA tensors -> csrc/mesh_shader.cu."""
    if not mats.is_cuda:
        return mesh_shader_plain(dm, tcnt, count, mats, posT, attrT, width,
                                 height, payload_base, backface_cull,
                                 sort_tris)
    cap = dm.shape[0]
    ncols = posT.shape[1]
    chk = _cuda.check
    chk(dm, "dm", torch.int32, (cap,))
    chk(tcnt, "tcnt", torch.int32, (cap,))
    chk(count, "count", torch.int32, (1,))
    chk(mats, "mats", torch.float32, (cap, 26))
    chk(posT, "mv_posT", torch.float32, (12, ncols))
    chk(attrT, "mv_attrT", torch.float32, (16, ncols))
    dev = mats.device
    coefT = torch.empty(((cap + 1) * WINDOW, COEF_ROWS), dtype=torch.int32,
                        device=dev)
    meta = torch.empty((META_ROWS, cap * WINDOW), dtype=torch.float32,
                       device=dev)
    p, ci = _cuda.ptr, _cuda.cint
    _cuda.launch("chord_mesh_shader", p(dm), p(tcnt), p(count), p(mats),
                 p(posT), p(attrT), ci(ncols), ci(cap), ci(width),
                 ci(height), ci(payload_base), ci(backface_cull),
                 ci(sort_tris), p(coefT), p(meta), _cuda.stream())
    mesh_shader.launches += 1
    return coefT, meta


mesh_shader.launches = 0
