"""The port's texture host path and mip selection against chord_tpu's.

Host arrays are built with the same numpy arithmetic in both packages and
must be equal exactly: the texture pool and its mips, the bench texture
set, page compression, the paged pool layout, the textured bistro's
materials and its meshlet pools. The per-pixel mip level is log2 of a uv
footprint: torch's and XLA's log2 may differ by an ulp, which can move a
value that sits on a power of two across a level boundary, so the integer
mips must agree on >= 99.9% of pixels and never differ by more than 1.
The port's `sample_pool` (the sampling oracle) must equal chord_tpu's to
1e-6 (XLA's CPU backend contracts the bilinear sums into FMAs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chord_tpu.asset import procedural as jproc
from chord_tpu.asset import texture as jtex
from chord_tpu.ops import paged_texture as jpt
from chord_tpu.ops import texture as jto

from chord_tpu_torch.asset import procedural as proc
from chord_tpu_torch.asset import texture as tex
from chord_tpu_torch.ops import paged_texture as pt
from chord_tpu_torch.ops import texture as to


@pytest.fixture(scope="module")
def bench_pools():
    return jproc.bench_texture_pool(), proc.bench_texture_pool()


def test_texture_pool_and_mips_match():
    rng = np.random.default_rng(4)
    imgs = [rng.random((32, 32, 4)).astype(np.float32) for _ in range(3)]
    jp, tp = jtex.TexturePool(32), tex.TexturePool(32)
    for i, im in enumerate(imgs):
        assert jp.add(f"t{i}", im) == tp.add(f"t{i}", im) == i
    assert tp.add("t1", imgs[0]) == 1          # names dedupe
    assert tp.mip_sizes == jp.mip_sizes and tp.mip_offsets == jp.mip_offsets
    np.testing.assert_array_equal(np.stack(tp.textures),
                                  np.stack(jp.textures))
    np.testing.assert_array_equal(tp.device_array(device="cpu").numpy(),
                                  np.asarray(jp.device_array()))
    for a, b in zip(tex.build_mips(imgs[0][:20, :12]),
                    jtex.build_mips(imgs[0][:20, :12])):
        np.testing.assert_array_equal(a, b)
    # an empty pool still has one (zero) layer
    np.testing.assert_array_equal(
        tex.TexturePool(8).device_array(device="cpu").numpy(),
        np.asarray(jtex.TexturePool(8).device_array()))


def test_bench_texture_pool_matches(bench_pools):
    jp, tp = bench_pools
    assert len(tp.textures) == 12 and tp.size == 256
    assert {k: d.layer for k, d in tp.descs.items()} == \
        {k: d.layer for k, d in jp.descs.items()}
    np.testing.assert_array_equal(tp.u8(), np.asarray(jp.device_array()))


@pytest.mark.parametrize("compress", [False, True])
def test_pack_paged_pool_matches(bench_pools, compress):
    jp, tp = bench_pools
    raw = tp.u8()
    pages, meta, n_mips = pt.pack_paged_pool(raw, tp.mip_sizes,
                                             tp.mip_offsets, compress)
    jpages, jmeta, jn = jpt.pack_paged_pool(raw, jp.mip_sizes,
                                            jp.mip_offsets, compress)
    assert n_mips == jn == 9
    np.testing.assert_array_equal(pages, np.asarray(jpages))
    np.testing.assert_array_equal(meta, np.asarray(jmeta))
    n_pages = pages.shape[0] // (2 if compress else 8)
    assert n_pages == 12 * 124          # 81+25+9+4+1+1+1+1+1 per layer
    assert pt.paged_pool_bytes(raw.shape, tp.mip_sizes, compress) == \
        pages.nbytes == jpt.paged_pool_bytes(raw.shape, jp.mip_sizes,
                                             compress)


def test_compress_and_decompress_pages_match():
    rng = np.random.default_rng(9)
    smooth = np.clip(np.cumsum(rng.integers(-9, 10, (32, 32, 4)), 1) + 128,
                     0, 255).astype(np.uint8)
    for img in (rng.integers(0, 256, (32, 32, 4)).astype(np.uint8), smooth,
                np.full((32, 32, 4), 77, np.uint8)):
        comp = pt.compress_page(img)
        np.testing.assert_array_equal(comp, jpt.compress_page(img))
        np.testing.assert_array_equal(pt.decompress_page(comp),
                                      jpt.decompress_page(comp))
    # a flat page survives compression exactly
    np.testing.assert_array_equal(pt.decompress_page(comp), img)


def test_bistro_materials_and_texture_pools_match():
    jb = jproc.build_bistro_like(detail=1, textures=True)
    b = proc.build_bistro_like(detail=1, textures=True)
    assert len(b.materials) == len(jb.materials)
    for m, jm in zip(b.materials, jb.materials):
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert sum(m.alpha_mode == "mask" for m in b.materials) == 1
    assert sum(m.base_color_texture >= 0 for m in b.materials) > 2
    np.testing.assert_array_equal(b.texture_pool.u8(),
                                  np.asarray(jb.texture_pool.device_array()))


def _uv_field(h, w, seed):
    """Perspective-like uv: density grows down the image, plus a few
    discontinuities (object edges)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 1.0 + 6.0 * (1.0 - yy / h)
    uv = np.stack([xx / w * 3.0 * z + 0.1 * np.sin(yy / 5.0),
                   z * 0.7 + yy / h], -1).astype(np.float32)
    edge = rng.random((h, w)) < 0.02
    uv[edge] += rng.uniform(-3, 3, (int(edge.sum()), 2)).astype(np.float32)
    return uv


@pytest.mark.parametrize("frame", [0, 5, 77])
def test_mip_selection_matches(frame):
    uv = _uv_field(64, 128, frame)
    ref = np.asarray(jto.mip_from_uv_density(jnp.asarray(uv), 256))
    got = to.mip_from_uv_density(torch.from_numpy(uv), 256).numpy()
    assert got.dtype == np.int32 and len(np.unique(got)) > 3
    assert (got == ref).mean() >= 0.999 and np.abs(got - ref).max() <= 1
    ref = np.asarray(jto.mip_dithered(jnp.asarray(uv), 256, frame))
    got = to.mip_dithered(torch.from_numpy(uv), 256,
                          torch.tensor(frame, dtype=torch.int32)).numpy()
    assert (got == ref).mean() >= 0.999 and np.abs(got - ref).max() <= 1


@pytest.mark.parametrize("bilinear", [True, False])
def test_sample_pool_matches(bench_pools, bilinear):
    jp, tp = bench_pools
    raw = tp.u8()
    rng = np.random.default_rng(1)
    layer = rng.integers(-1, 12, (48, 64)).astype(np.int32)
    uv = rng.uniform(-2, 2, (48, 64, 2)).astype(np.float32)
    mip = rng.integers(-1, 11, (48, 64)).astype(np.int32)
    ref = np.asarray(jto.sample_pool(
        jnp.asarray(raw), tuple(jp.mip_sizes), tuple(jp.mip_offsets),
        jnp.asarray(layer), jnp.asarray(uv), jnp.asarray(mip),
        bilinear=bilinear))
    got = to.sample_pool(torch.from_numpy(raw), tp.mip_sizes, tp.mip_offsets,
                         torch.from_numpy(layer), torch.from_numpy(uv),
                         torch.from_numpy(mip), bilinear=bilinear).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got[layer < 0] == 1.0).all()
