"""Prototype paged texture sampler with a page palette (port of
tools/proto_paged_tex.py).

Builds the prototype's tiled pool (build_tiled_pool), samples a coherent
1080p-like uv field through the palette sampler, kernel K10
(chord_tpu_torch/ops/proto_paged_tex.py: the K=6 smallest distinct tiles
of each (32,128) pixel block are served, the others get the entry's
average colour), holds it against a numpy oracle and times it.

    python3 -m chord_tpu_torch.tools.proto_paged_tex    # on the card
    main(device="cpu")                                   # plain version
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import proto_paged_tex as sampler
# the reference tool's names, kept here
from ..ops.proto_paged_tex import (BH, K, TILE,  # noqa: F401
                                   paged_sample_plain)

REPS = 8            # timed calls in main()


def build_tiled_pool(images):
    """images: list of (s, s, 4) u8 (one per (layer,mip) entry, any sizes)
    -> (pool (n_tiles*8, 128) int32, meta (4, 128) int32) numpy arrays;
    meta rows: first tile, tiles per row, size, average colour (packed)."""
    tiles = []
    base_tile, tiles_x, sizes, avgs = [], [], [], []
    for img in images:
        s = img.shape[0]
        base_tile.append(len(tiles))
        tx = max((s + TILE - 1) // TILE, 1)
        tiles_x.append(tx)
        sizes.append(s)
        packed = (img[..., 0].astype(np.uint32) |
                  (img[..., 1].astype(np.uint32) << 8) |
                  (img[..., 2].astype(np.uint32) << 16) |
                  (img[..., 3].astype(np.uint32) << 24))
        avg = img.reshape(-1, 4).mean(0).astype(np.uint32)
        avgs.append(int(avg[0] | (avg[1] << 8) | (avg[2] << 16) |
                        (avg[3] << 24)))
        ty = max((s + TILE - 1) // TILE, 1)
        pad = np.zeros((ty * TILE, tx * TILE), np.uint32)
        pad[:s, :s] = packed
        for iy in range(ty):
            for ix in range(tx):
                t = pad[iy * TILE:(iy + 1) * TILE, ix * TILE:(ix + 1) * TILE]
                tiles.append(t.reshape(8, 128))       # slot-major
    pool = np.concatenate(tiles, 0).astype(np.uint32).view(np.int32)
    n = len(base_tile)
    if n > 128:
        raise ValueError(f"{n} entries: meta holds at most 128")
    meta = np.zeros((4, 128), np.int32)
    meta[0, :n] = base_tile
    meta[1, :n] = tiles_x
    meta[2, :n] = sizes
    meta[3, :n] = np.asarray(avgs, np.uint32).view(np.int32)
    return pool, meta


def paged_sample(pool: torch.Tensor, meta: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, lm: torch.Tensor):
    """Kernel K10 -> (out, cov); calls the sampler through its module so
    kernels.capture_inputs sees the call."""
    return sampler.paged_sample(pool, meta, u, v, lm)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None) -> dict:
    """The prototype at its own size: 4 layers x mips 256..1, a 1056x1920
    coherent uv field at mip 2 with a 64-px untextured strip; checks the
    sampler against a numpy oracle and times REPS calls. `device` defaults
    to the card. -> {"covered", "match", "untextured_ok", "ms", ...}."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    rng = np.random.default_rng(0)
    # build a pool: 4 layers x mips 256..1
    entries = []
    for layer in range(4):
        s = 256
        mips = []
        while s >= 1:
            mips.append(rng.integers(0, 255, (s, s, 4)).astype(np.uint8))
            s //= 2
        entries.append(mips)
    n_mips = len(entries[0])
    flat = [m for ms in entries for m in ms]
    pool_np, meta_np = build_tiled_pool(flat)
    print(f"pool: {pool_np.shape} = {pool_np.nbytes / 2**20:.2f} MiB")

    h, w = 1080 // BH * BH, 1920
    # synthetic uv field: smooth gradient + per-region layers (coherent,
    # like a real frame); mip from density
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (xx / w * 3.1) % 1.0
    v = (yy / h * 1.7) % 1.0
    layer = ((xx // 480) % 4).astype(np.int32)
    mip = np.full((h, w), 2, np.int32)   # 256/4=64 texels across ~crisp
    lm = layer * n_mips + mip
    lm[:, :64] = -1                      # untextured strip

    pool, meta = (torch.from_numpy(a).to(dev) for a in (pool_np, meta_np))
    ut, vt, lmt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (u, v, lm))
    out, cov = paged_sample(pool, meta, ut, vt, lmt)
    out_np, cov_np = out.cpu().numpy(), cov.cpu().numpy()

    # numpy oracle (nearest)
    sizes = np.asarray([max(256 >> m, 1) for m in range(n_mips)])
    ref = np.zeros((h, w), np.uint32)
    for lay in range(4):
        for m in range(n_mips):
            mask = (layer == lay) & (mip == m) & (lm >= 0)
            if not mask.any():
                continue
            s = sizes[m]
            img = entries[lay][m]
            xt = np.clip((u[mask] % 1.0 * s).astype(np.int64), 0, s - 1)
            yt = np.clip((v[mask] % 1.0 * s).astype(np.int64), 0, s - 1)
            px = img[yt, xt].astype(np.uint32)
            ref[mask] = (px[:, 0] | (px[:, 1] << 8) |
                         (px[:, 2] << 16) | (px[:, 3] << 24))
    refi = ref.view(np.int32)
    tex_px = lm >= 0
    good = cov_np[tex_px] > 0
    match = out_np[tex_px][good] == refi[tex_px][good]
    print(f"covered: {good.mean() * 100:.2f}%  "
          f"exact-match among covered: {match.mean() * 100:.3f}%")
    untextured_ok = bool((out_np[~tex_px] == -1).all())
    if not untextured_ok:
        raise AssertionError("untextured pixels are not -1")

    # timing
    _sync(dev)
    t0 = time.time()
    for _ in range(REPS):
        out, cov = paged_sample(pool, meta, ut, vt, lmt)
    _sync(dev)
    ms = (time.time() - t0) / REPS * 1000
    print(f"paged sample 1080p: {ms:.2f} ms")
    return dict(pool_shape=tuple(pool_np.shape), pool_bytes=pool_np.nbytes,
                hw=(h, w), covered=float(good.mean()),
                match=float(match.mean()), untextured_ok=untextured_ok,
                ms=ms, device=str(dev))


if __name__ == "__main__":
    main()
