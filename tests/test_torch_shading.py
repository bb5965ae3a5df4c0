"""The port's textured shading against chord_tpu's on the same seeded
raster planes (128x64): the textured g-buffer resolve (base, metal-rough,
emissive and normal maps, and the dithered trilinear mip), the masked
bucket's alpha test and the blend bucket's forward shade, textured and
not.

Both packages get the same pools (chord_tpu's, carried over with
`interop`; raw texture pages) and the same planes. The point here is the
shading arithmetic, so chord_tpu's paged sampler is replaced in this file
by its gather oracle: chord_tpu's `sample_pool` over the raw pool in u8
units, rounded to u8 as the kernel rounds. That is the function the
sampler computes where its palette covers (K5 itself is held to
chord_tpu's Pallas sampler in test_torch_paged_texture.py, and the whole
frame in test_torch_frame_tex.py).

Tolerances: masks (valid, accept, hit) are exact. Float outputs are held
to 2e-5 absolute on >= 99.9% of values, the slack for XLA's FMA
contraction and rsqrt / pow ulps; a pixel whose texel moves by one u8
level (a filter sum on a .5 boundary) or whose mip flips (a log2 ulp at a
power of two) may differ by up to the texture's own step, so no value may
differ by more than 0.1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chord_tpu.asset.procedural as jproc
import chord_tpu.asset.texture as jtex
import chord_tpu.ops.paged_texture as jpt
import chord_tpu.rhi.scene_arrays as jsa
import chord_tpu.utils.math as jmath
from chord_tpu.ops import shading as jshading
from chord_tpu.ops import texture as jto
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.rhi.framebuffer import pack_visibility as jpack
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

from chord_tpu_torch import interop
from chord_tpu_torch.ops import shading
from test_torch_frame_tex import build_textured_scene

W, H = 128, 64
CAP = 16


def _np(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


@pytest.fixture(scope="module")
def state():
    jb = build_textured_scene(jproc, jsa, jtex, jmath)
    jpools = jax_pools(jb, texture_pool=jb.texture_pool,
                       texture_compress=False)
    cam = JCamera(width=W, height=H)
    for i, x in enumerate((0.2, 0.5)):      # a moving camera: real motion
        cam.position = np.array([x, 2.0, 5.5])
        cam.look_at(np.array([0.0, 1.0, -3.0]))
        u = cam.view_uniform(i + 1, jitter=True)
    jinst = jb.frame_instances(cam)
    jview = JView.from_uniform(u)

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    # 8x16-pixel regions, each one draw slot (or a miss)
    reg = rng.integers(-1, CAP, (H // 8, W // 16)).astype(np.int32)
    slot = np.repeat(np.repeat(reg, 8, 0), 16, 1)
    vis = np.asarray(jpack(jnp.asarray(slot),
                           jnp.asarray(rng.integers(0, 128, (H, W)))))
    sf = slot.astype(np.float32)
    planes = dict(
        vis=vis,
        # reverse-Z with z_near 1e-3: surfaces 2-10 units away
        depth=(1e-4 + 4e-4 * (1 - yy / H) + 1e-5 * sf).astype(np.float32),
        nx=(0.3 * np.sin(xx / 9 + sf) + 0.05).astype(np.float32),
        ny=(0.8 + 0.1 * np.cos(yy / 7)).astype(np.float32),
        nz=(0.4 * np.cos(xx / 13 - sf)).astype(np.float32),
        u=(xx / W * 1.7 + 0.13 * sf).astype(np.float32),
        v=(yy / H * 1.1 - 0.07 * sf).astype(np.float32))
    n_obj = len(jb.instances)
    draw_object = (np.arange(CAP) % n_obj).astype(np.int32)
    port = dict(pools=interop.pools_from_numpy(_np(jpools), device="cpu"),
                inst=interop.instances_from_numpy(_np(jinst), device="cpu"),
                view=interop.view_from_numpy(_np(jview), device="cpu"))
    return dict(jax=(jpools, jinst, jview), port=port, planes=planes,
                draw_object=draw_object, raw=np.asarray(jpools.tex_pool))


@pytest.fixture
def oracle_sampler(state, monkeypatch):
    """chord_tpu's paged sampler -> its full-coverage gather oracle."""
    pool = jnp.asarray(state["raw"].astype(np.float32))

    def sample(pages, meta, n_mips, mip_sizes, layers, uv, mip,
               bilinear=True, **_):
        sizes = tuple(mip_sizes[:n_mips])
        offs = tuple(int(x) for x in np.cumsum([0] + [s * s for s in
                                                      sizes[:-1]]))
        out = jnp.stack([jto.sample_pool(pool, sizes, offs, layers[c], uv,
                                         mip, bilinear=bilinear)
                         for c in range(layers.shape[0])])
        if bilinear:
            out = jnp.clip(out + 0.5, 0.0, 255.0).astype(jnp.int32)
        out = out.astype(jnp.float32) * (1.0 / 255.0)
        return jnp.where((layers >= 0)[..., None], out, 1.0)

    monkeypatch.setattr(jpt, "paged_sample", sample)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    d = np.abs(got - ref)
    assert (d <= 2e-5).mean() >= 0.999, (name, d.max(), (d > 2e-5).mean())
    assert d.max() <= 0.1, (name, d.max())


@pytest.mark.parametrize("flags", [
    dict(textured=True),
    dict(textured=True, pbr_textures=True, normal_mapped=True),
    dict(textured=True, pbr_textures=True, normal_mapped=True,
         mip_dither_frame=5)])
def test_textured_resolve_matches(state, oracle_sampler, flags):
    jpools, jinst, jview = state["jax"]
    p, pl = state["port"], state["planes"]
    names = ("vis", "depth", "nx", "ny", "nz", "u", "v")
    ref = jshading.resolve_gbuffer_raster_rt(
        *[jnp.asarray(pl[k]) for k in names],
        jnp.asarray(state["draw_object"]), jpools, jinst, jview.clip_to_tw,
        jview.tw_to_clip_nj, jview.prev_tw_to_clip_nj, motion_div=2,
        interpret=True, **flags)
    port_flags = dict(flags)
    if "mip_dither_frame" in port_flags:
        port_flags["mip_dither_frame"] = torch.tensor(5, dtype=torch.int32)
    got = shading.resolve_gbuffer_raster_rt(
        *[_t(pl[k]) for k in names], _t(state["draw_object"]), p["pools"],
        p["inst"], p["view"].clip_to_tw, p["view"].tw_to_clip_nj,
        p["view"].prev_tw_to_clip_nj, motion_div=2, **port_flags)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0.3 < got.valid.numpy().mean() < 1.0
    for f in got._fields:
        if f != "valid":
            _close(getattr(got, f).numpy(), getattr(ref, f), f)
    # the maps did something: textured base differs from the constants
    plain = shading.resolve_gbuffer_raster_rt(
        *[_t(pl[k]) for k in names], _t(state["draw_object"]), p["pools"],
        p["inst"], p["view"].clip_to_tw, p["view"].tw_to_clip_nj,
        p["view"].prev_tw_to_clip_nj, motion_div=2)
    assert (plain.base_color != got.base_color).any()
    if flags.get("normal_mapped"):
        assert (plain.normal != got.normal).any()
        assert (plain.roughness != got.roughness).any()


def test_alpha_mask_accept_matches(state, oracle_sampler):
    jpools, jinst, _ = state["jax"]
    p, pl = state["port"], state["planes"]
    base = 40          # masked slots ride above the opaque phases' slots
    slot = (np.asarray(pl["vis"]).view(np.int32) >> 7) - 1
    vis_m = np.asarray(jpack(jnp.asarray(np.where(slot >= 0, slot + base,
                                                  -1)),
                             jnp.zeros((H, W), jnp.int32)))
    depth_o = (pl["depth"] * np.float32(0.9)).astype(np.float32)
    depth_o[:, :W // 3] = 1.0         # opaque in front on the left third
    args = [vis_m, pl["depth"], depth_o, pl["u"], pl["v"]]
    ref = jshading.alpha_mask_accept(
        *[jnp.asarray(a) for a in args], jnp.asarray(state["draw_object"]),
        base, jpools, jinst, interpret=True)
    got = shading.alpha_mask_accept(
        *[_t(a) for a in args], _t(state["draw_object"]), base, p["pools"],
        p["inst"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    hit, keep = shading.masked_alpha_keep(
        _t(vis_m), _t(pl["u"]), _t(pl["v"]), _t(state["draw_object"]), base,
        p["pools"], p["inst"])
    jhit, jkeep = jshading.masked_alpha_keep(
        jnp.asarray(vis_m), jnp.asarray(pl["u"]), jnp.asarray(pl["v"]),
        jnp.asarray(state["draw_object"]), base, jpools, jinst,
        interpret=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # the leaf cards' alpha holes reject some hit pixels, keep others
    assert got.any() and (hit & ~keep).any()


@pytest.mark.parametrize("textured", [False, True])
def test_shade_blend_layer_matches(state, oracle_sampler, textured):
    jpools, jinst, jview = state["jax"]
    p, pl = state["port"], state["planes"]
    depth_o = (pl["depth"] * np.float32(0.95)).astype(np.float32)
    depth_o[:8] = 1.0
    args = [pl["vis"], pl["depth"], depth_o, pl["nx"], pl["ny"], pl["nz"],
            pl["u"], pl["v"]]
    jsun = jshading.SunLight(direction=jview.sun_direction,
                             radiance=jview.sun_radiance,
                             sky_ambient=jview.sky_ambient)
    v = p["view"]
    sun = shading.SunLight(direction=v.sun_direction,
                           radiance=v.sun_radiance,
                           sky_ambient=v.sky_ambient)
    rc, ra = jshading.shade_blend_layer(
        *[jnp.asarray(a) for a in args], jnp.asarray(state["draw_object"]),
        jpools, jinst, jsun, interpret=True, textured=textured)
    gc, ga = shading.shade_blend_layer(
        *[_t(a) for a in args], _t(state["draw_object"]), p["pools"],
        p["inst"], sun, textured=textured)
    _close(gc.numpy(), rc, "color")
    _close(ga.numpy(), ra, "alpha")
    assert (ga.numpy() > 0).any() and (ga.numpy() == 0).any()


def test_flat_resolve_gbuffer_matches():
    """The flat frame's resolve (triangle = payload - 1 into the flat pools,
    perspective-correct barycentrics, per-object motion) on the port's own
    raster of the tiny atrium, with moved objects. Tolerance: 1e-4
    relative to max(|ref|, 1) on >= 99.9% of values (barycentric sums and
    the matrix chains in another rounding; a pixel on a triangle's edge
    magnifies them), masks exact."""
    from chord_tpu.asset.procedural import build_sponza_like as jax_sponza
    from chord_tpu_torch.ops.raster import RasterConfig, rasterize
    from chord_tpu_torch.ops.transform import transform_to_clip

    jb = jax_sponza(detail=1)
    jpools = jb.build_pools()
    cam = JCamera(width=W, height=H)
    cam.position = np.array([-15.0, 4.0, 0.0])
    cam.look_at(np.array([10.0, 2.0, 0.0]))
    # every third object moved since the previous frame
    prev = {}
    for o, (_, _, m) in enumerate(jb.instances):
        if o % 3 == 0:
            mm = np.array(m, np.float64)
            mm[3, :3] += [0.2, 0.1, -0.3]
            prev[o] = cam.rebase_matrix(mm)
    jinst = jb.frame_instances(cam, prev_matrices=prev)
    jview = JView.from_uniform(cam.view_uniform(1, jitter=True))
    pools = interop.scene_pools_from_numpy(_np(jpools), device="cpu")
    inst = interop.instances_from_numpy(_np(jinst), device="cpu")
    view = interop.view_from_numpy(_np(jview), device="cpu")
    clip = transform_to_clip(pools.positions, pools.vertex_object,
                             inst.object_to_tw, view.tw_to_clip)
    n = pools.num_triangles
    _, vis, _ = rasterize(clip, pools.indices, pools.tri_valid,
                          torch.arange(1, n + 1, dtype=torch.int32),
                          RasterConfig(width=W, height=H, tile_h=32,
                                       sub_s=8, big_capacity=128))
    assert 0.3 < (vis > 0).float().mean() < 1.0
    ref = jshading.resolve_gbuffer(
        jnp.asarray(vis.numpy().view(np.uint32)), jpools, jinst,
        jview.tw_to_clip_nj, jview.prev_tw_to_clip_nj)
    got = shading.resolve_gbuffer(vis, pools, inst, view.tw_to_clip_nj,
                                  view.prev_tw_to_clip_nj)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for name in got._fields[1:]:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        bad = np.abs(g - r) > 1e-4 * np.maximum(np.abs(r), 1.0)
        assert bad.mean() <= 1e-3, (name, np.abs(g - r).max())
    assert np.abs(np.asarray(ref.motion)).max() > 1e-3   # real motion

