"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: each test skips where torch sees no CUDA device (the CPU
test runs); on the GPU machine run them with

    python3 -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: tests/conftest.py configures JAX, which that machine lacks).

Tolerance: 0. The kernels are built with -fmad=false and round every
product and sum as the plain versions do, so every output must match bit
for bit (integer outputs exactly; float outputs bit for bit, NaN where
NaN).
"""

import numpy as np
import pytest
import torch

from chord_tpu_torch.asset.procedural import (bench_texture_pool,
                                              build_bistro_like,
                                              build_sponza_like)
from chord_tpu_torch.ops import (_cuda, _util, fusion_barrier, kernels,
                                 mesh_shader, paged_texture, raster,
                                 row_gather, shadow, shadow_kernel,
                                 tile_reproject)
from chord_tpu_torch.ops import atmosphere as atm
from chord_tpu_torch.ops import brdf_lut, gi, rt
from chord_tpu_torch.ops.ddgi import DDGIConfig
from chord_tpu_torch.ops.gi import GIConfig
from chord_tpu_torch.native import bvh_build
from chord_tpu_torch.ops.screen_probe import ScreenProbeConfig
from chord_tpu_torch.ops import proto_paged_tex as proto_sampler
from chord_tpu_torch.renderer import (DeferredRenderer, DeviceView,
                                      MeshletFrameConfig, RendererConfig,
                                      render_frame_flat,
                                      render_sequence_meshlet,
                                      render_sequence_split)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.tools import proto_paged_tex, repro_eval_kernel
from chord_tpu_torch.utils.camera import Camera
from chord_tpu_torch.utils.cvar import cvars
import rt_cases
from proto_palette_cases import sampler_inputs, tile_cases
from test_torch_raster_bands import CASES as BAND_CASES
from test_torch_paged_footprint import footprint_inputs
from paged_palette_cases import (EDGE_CASES, MISS_CASES, edge_case,
                                 miss_inputs)
from test_torch_raster_bands import band_inputs

W, H, PW, PH = 128, 64, 192, 96
CFG = RendererConfig(width=W, height=H, post_width=PW, post_height=PH,
                     pair_capacity=4096, big_capacity=128, tsr_mode="tile")
MCFG = MeshletFrameConfig(draw_capacity=1024)
# the geo_tex rung (bench.py:204-219): maps, masked and blend buckets
TEX_MCFG = MeshletFrameConfig(draw_capacity=1024, masked_draw_capacity=256,
                              textured=True, normal_mapped=True,
                              pbr_textures=True, alpha_masked=True,
                              alpha_blend=True, blend_textured=False)
# the geo_shadow_atmo rung (bench.py:42-44): geo_tex + shadows + atmosphere
SHADOW_CFG = shadow.ShadowConfig(cascade_count=2, resolution=256)
SHADOW_MCFG = TEX_MCFG._replace(shadows=True, atmosphere=True,
                                shadow_cfg=SHADOW_CFG)
# the all rung without BVH rays: geo_shadow_atmo + screen-probe GI + SSR
GI_CFG = GIConfig(cascades=2, probe_dim=8)
GI_MCFG = SHADOW_MCFG._replace(
    gi=True, gi_mode="probe", ssr=True, trilinear=True, gi_cfg=GI_CFG,
    probe_cfg=ScreenProbeConfig(rays=16, steps=6, history_mode="tile"))
# the all rung: with the BVH rays over the scene's object spheres
RT_MCFG = GI_MCFG._replace(gi_rt=True, rt_rays=2)
# all_ddgi: DDGI probe volumes over a meshlet BVH; all_exact: the
# triangle-exact BVH, RTAO and the probe march
DDGI_MCFG = RT_MCFG._replace(gi_mode="ddgi", ddgi_cfg=DDGIConfig(),
                             rt_granularity="meshlet")
EXACT_MCFG = RT_MCFG._replace(
    rt_granularity="triangle", gi_cfg=GI_CFG._replace(ao_mode="rtao"),
    probe_cfg=ScreenProbeConfig(trace_mode="march", rays=16, steps=6,
                                history_mode="tile"))
# all_cache: the world-cache GI (no screen probes), the viewer's
# --gi --gi-mode cache --gi-rt
CACHE_MCFG = RT_MCFG._replace(gi_mode="cache")
# geo_tex_native: geo_tex at render size with gather TSR and the masked
# depth peel; off_no_occlusion: off without occlusion or pre-cull, global
# TSR upscale, HDR10
NATIVE_CFG = CFG._replace(post_width=0, post_height=0, tsr_mode="gather")
NATIVE_MCFG = TEX_MCFG._replace(masked_layers=2)
NO_OCC_CFG = CFG._replace(tsr_mode="global", output="hdr10")
NO_OCC_MCFG = MCFG._replace(occlusion=False, object_precull=False)
# geo_shadow_atmo_split: the shadow rung with the pipelined shadow split
SPLIT_MCFG = SHADOW_MCFG._replace(
    shadow_cfg=SHADOW_CFG._replace(pipelined=True))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the GPU)")
    return torch.device("cuda", 0)


def _tex_sequence(d, frames=3, shadows=False, gi=False, native=False,
                  ddgi=False, cache=False):
    """The small textured bistro along bench.py's camera path, jittered;
    with shadows, the views carry the cascade fit and the atmosphere LUTs
    and the history the cascade cache; with gi, the views also carry the
    env-BRDF LUT and the history the GI state (DDGI's in place of the
    screen probes' with `ddgi`, none with `cache`); `native`: the history at render size (no
    upscale)."""
    b = build_bistro_like(detail=1, textures=True)
    cam = Camera(width=W, height=H)
    vs = []
    for i in range(frames):
        t = i / 15
        cam.position = np.array([-45.0 + 70.0 * t, 5.0, 4.0])
        cam.look_at(np.array([55.0, 3.0, -4.0]))
        vs.append(DeviceView.from_uniform(
            cam.view_uniform(i, jitter=True), device=d,
            shadow_cfg=SHADOW_CFG if shadows else None))
    hist = (FrameHistory.empty(H, W, device=d) if native else
            FrameHistory.empty(H, W, PH, PW, device=d))
    if shadows:
        p = atm.AtmosphereParams()
        t_lut = atm.build_transmittance_lut(p, 40, device=d)
        ms = atm.build_multiscatter_lut(p, t_lut, dir_samples=16, steps=12)
        sky = atm.build_sky_view_lut(p, t_lut, ms, vs[0].sun_direction)
        vs = [v.replace(atmo_t_lut=t_lut, atmo_ms_lut=ms, atmo_sky_lut=sky)
              for v in vs]
        hist = FrameHistory.empty(H, W, PH, PW, shadow_div=4,
                                  shadow_cascades=2, shadow_res=256,
                                  gi_cfg=GI_CFG if gi else None,
                                  probe_tile=(8 if gi and not ddgi
                                              and not cache else 0),
                                  ddgi_cfg=DDGIConfig() if ddgi else None,
                                  device=d)
    if gi:
        lut = brdf_lut.build_env_brdf_lut(64, device=d)
        vs = [v.replace(brdf_lut=lut) for v in vs]
    return (build_meshlet_pools(b, texture_pool=b.texture_pool, device=d),
            b.frame_instances(cam, device=d), DeviceView.stack(vs), hist)


def _baseline_sequence(d, scene, frames=3):
    """BASELINE #4 (`interior`: build_bistro_interior(detail=1) on
    bench.py's interior camera path, with the shadow and GI history and
    LUTs of the `all` rung) or #3 (`nanite`: a 3x3 field of
    build_nanite_stress spheres on the orbit path), jittered."""
    from chord_tpu_torch.asset.procedural import (build_bistro_interior,
                                                  build_nanite_stress)

    gi_ = scene == "interior"
    b = (build_bistro_interior(detail=1) if gi_
         else build_nanite_stress(spheres=9, rings=16))
    cam = Camera(width=W, height=H)
    vs = []
    for i in range(frames):
        t = i / 15
        if gi_:
            cam.position = np.array([-6.0 + 3.0 * t, 2.2, 3.6 - 1.5 * t])
            cam.look_at(np.array([6.0, 1.2, -2.0]))
        else:
            a = t * 1.5
            cam.position = np.array([20.0 * np.cos(a), 6.0,
                                     20.0 * np.sin(a)])
            cam.look_at(np.array([0.0, 2.0, 0.0]))
        vs.append(DeviceView.from_uniform(
            cam.view_uniform(i, jitter=True), device=d,
            shadow_cfg=SHADOW_CFG if gi_ else None))
    hist = FrameHistory.empty(H, W, PH, PW, device=d)
    if gi_:
        p = atm.AtmosphereParams()
        t_lut = atm.build_transmittance_lut(p, 40, device=d)
        ms = atm.build_multiscatter_lut(p, t_lut, dir_samples=16, steps=12)
        sky = atm.build_sky_view_lut(p, t_lut, ms, vs[0].sun_direction)
        lut = brdf_lut.build_env_brdf_lut(64, device=d)
        vs = [v.replace(atmo_t_lut=t_lut, atmo_ms_lut=ms, atmo_sky_lut=sky,
                        brdf_lut=lut) for v in vs]
        hist = FrameHistory.empty(H, W, PH, PW, shadow_div=4,
                                  shadow_cascades=2, shadow_res=256,
                                  gi_cfg=GI_CFG, probe_tile=8, device=d)
    return (build_meshlet_pools(b, nanite=True, device=d),
            b.frame_instances(cam, device=d), DeviceView.stack(vs), hist)


def _path_run(path, d):
    """-> (sequence inputs on `d`, frame config) of a meshlet path."""
    if path == "interior":
        return _baseline_sequence(d, path), RT_MCFG
    if path == "nanite":
        return _baseline_sequence(d, path), MCFG
    if path == "geo_shadow_atmo_split":
        return _tex_sequence(d, shadows=True), SPLIT_MCFG
    if path == "off":
        return _sequence(d), MCFG
    if path == "off_no_occlusion":
        return _sequence(d), NO_OCC_MCFG
    if path == "geo_tex_native":
        return _tex_sequence(d, native=True), NATIVE_MCFG
    if path in ("geo_tex", "geo_tex_bricks"):
        return _tex_sequence(d), TEX_MCFG
    if path == "all_no_rt":
        return _tex_sequence(d, shadows=True, gi=True), GI_MCFG
    if path in ("all", "all_4k"):     # all_4k's 4K shapes: chip_smoke's
        return _tex_sequence(d, shadows=True, gi=True), RT_MCFG
    if path == "all_cache":
        return (_tex_sequence(d, shadows=True, gi=True, cache=True),
                CACHE_MCFG)
    if path == "all_ddgi":
        return _tex_sequence(d, shadows=True, gi=True, ddgi=True), DDGI_MCFG
    if path == "all_exact":
        return _tex_sequence(d, shadows=True, gi=True), EXACT_MCFG
    return _tex_sequence(d, shadows=True), SHADOW_MCFG


# the flat path: the tiny atrium's flat pools through DeferredRenderer
FLAT_CFG = RendererConfig(width=W, height=H, pair_capacity=4096,
                          big_capacity=128, subtiles=True)


def _render_path(path, d):
    """Render a kernels.PATHS path's tiny sequence on `d` -> (images (N,H,W,3)
    u8, stats {name: per-frame list}); geo_tex_bricks with the
    r.raster.bricks cvar set for the run."""
    if path == "flat":
        b = build_sponza_like(detail=1)
        pools = b.build_pools(device=d)
        r = DeferredRenderer(FLAT_CFG)
        cam = Camera(width=W, height=H)
        imgs, stats = [], []
        for i in range(3):
            cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
            cam.look_at(np.array([10.0, 2.0, 0.0]))
            img, st = r.render(pools, b.frame_instances(cam, device=d),
                               cam.view_uniform(i, jitter=True))
            imgs.append(img)
            stats.append(st)
        return torch.stack(imgs), {k: [int(s[k]) for s in stats]
                                   for k in stats[0]}
    inputs, mcfg = _path_run(path, d)
    bvh = (rt.build_scene_bvh(inputs[0], inputs[1], granularity=(
        "object" if path in ("all", "interior", "all_4k", "all_cache")
        else mcfg.rt_granularity))
        if mcfg.gi_rt else None)
    cfg = {"geo_tex_native": NATIVE_CFG,
           "off_no_occlusion": NO_OCC_CFG}.get(path, CFG)
    run = (render_sequence_split if path == "geo_shadow_atmo_split"
           else render_sequence_meshlet)
    with cvars.override("r.raster.bricks", path == "geo_tex_bricks"):
        imgs, _, st = run(*inputs, cfg, mcfg, bvh=bvh, with_stats=True)
    return imgs, {k: v.cpu().tolist() for k, v in st.items()}


def _sequence(d, frames=3):
    b = build_sponza_like(detail=1)
    cam = Camera(width=W, height=H)
    cam.position = np.array([-15.0, 4.0, 0.0])
    cam.look_at(np.array([10.0, 2.0, 0.0]))
    vs = []
    for i in range(frames):
        cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
        vs.append(DeviceView.from_uniform(cam.view_uniform(i, jitter=True),
                                          device=d))
    return (build_meshlet_pools(b, device=d), b.frame_instances(cam, device=d),
            DeviceView.stack(vs), FrameHistory.empty(H, W, PH, PW, device=d))


def _exact(k, args, kwargs):
    got = kernels.outputs_list(k.fn()(*args, **kwargs))
    ref = kernels.outputs_list(k.plain(*args, **kwargs))
    torch.cuda.synchronize()
    assert kernels.max_abs_err(got, ref) == 0.0, k.name


@pytest.mark.cuda
def test_kernels_match_plain_on_frame_inputs(dev):
    """Every kernel, on the inputs of every one-process path that lists
    it (the sharded paths' are chip_smoke's)."""
    for path in kernels.FRAME_PATHS:
        kernels.reset_launch_counts()
        with kernels.capture_inputs() as captured:
            _render_path(path, dev)
        counts = kernels.launch_counts()
        for k in kernels.KERNELS:
            if path not in k.paths:
                assert not captured[k.name], (path, k.name)
                continue
            assert captured[k.name], (path, k.name)
            assert counts[k.name] == len(captured[k.name]), (path, k.name)
            for args, kwargs in captured[k.name]:
                _exact(k, args, kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
def test_paged_sample_random_inputs(dev, compress):
    """K5 on the bench pool at 720x1280: the resolve's 4-map bilinear call
    (16 pages) and the masked test's nearest call (10), random layers / uv
    / mips, where the palette misses and even the C+4 fallback pages
    overflow (the average colour shows); the palette cases of
    paged_palette_cases (hits, fallback and average in every block; sizes
    that are not whole blocks); then the footprints that read one, two and
    four 4x4 blocks across the tile seam (test_torch_paged_footprint), at
    the full and at an odd width. Coverage too."""
    tp = bench_texture_pool()
    pages, meta, n_mips = paged_texture.pack_paged_pool(
        tp.u8(), tp.mip_sizes, tp.mip_offsets, compress)
    rng = np.random.default_rng(5)
    cases = []
    for c, bilinear in ((4, True), (1, False)):
        layers = rng.integers(-1, 12, (c, 720, 1280)).astype(np.int32)
        uv = rng.uniform(-3, 3, (720, 1280, 2)).astype(np.float32)
        mip = rng.integers(-1, 11, (720, 1280)).astype(np.int32)
        cases.append((layers, uv, mip, bilinear))
    for c, _, _, bilinear, h, w in MISS_CASES:
        for b in (bilinear, not bilinear):
            cases.append((*miss_inputs(c, h, w, seed=c * 10 + h), b))
    layers, uv, mip = footprint_inputs()
    for w in (layers.shape[2], layers.shape[2] - 1):
        for bilinear in (True, False):
            cases.append((np.ascontiguousarray(layers[..., :w]),
                          np.ascontiguousarray(uv[:, :w]),
                          np.ascontiguousarray(mip[:, :w]), bilinear))
    shares = []
    for layers, uv, mip, bilinear in cases:
        args = [torch.from_numpy(pages), torch.from_numpy(meta), n_mips,
                tp.mip_sizes, torch.from_numpy(layers), torch.from_numpy(uv),
                torch.from_numpy(mip)]
        kw = dict(bilinear=bilinear, block_h=16,
                  k_pages=10 if layers.shape[0] == 1 else 16)
        ref, ref_cov = paged_texture.paged_sample_plain(
            *args, with_coverage=True, **kw)
        got, cov = paged_texture.paged_sample(
            *[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args],
            with_coverage=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref), (compress, layers.shape,
                                             bilinear)
        assert torch.equal(cov.cpu(), ref_cov), (compress, layers.shape)
        assert torch.equal(paged_texture.paged_sample(
            *[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args],
            **kw).cpu(), ref)
        shares.append(paged_texture.palette_shares(*args, **kw))
    # the random calls reach the average colour, the palette cases all
    # three outcomes
    assert all(h + f < 0.9 for h, f in shares[:2]), shares
    assert all(h > 0.1 and f > 0.01 and h + f < 0.95
               for h, f in shares[2:2 + 2 * len(MISS_CASES)]), shares



@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_paged_sample_edge_cases(dev, name):
    """K5 on the page-id edge cases of paged_palette_cases (exactly K and
    K + 1 distinct ids in a block, ids at or above n_pages and below 0,
    ids at or above BIG, a pool wider than the kernel's bitmap with ids far
    apart in one block, untextured and partial blocks), bilinear and
    nearest, with and without coverage: bit-equal to the plain version."""
    case = edge_case(name)
    args = [torch.from_numpy(case[k]) for k in ("pages", "meta")] + [
        case["n_mips"], case["mip_sizes"]] + [
        torch.from_numpy(case[k]) for k in ("layers", "uv", "mip")]
    on_dev = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    for bilinear in (True, False):
        kw = dict(bilinear=bilinear, block_h=16, k_pages=case["k_pages"])
        ref, ref_cov = paged_texture.paged_sample_plain(
            *args, with_coverage=True, **kw)
        got, cov = paged_texture.paged_sample(*on_dev, with_coverage=True,
                                              **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref), (name, bilinear)
        assert torch.equal(cov.cpu(), ref_cov), (name, bilinear)
        assert torch.equal(paged_texture.paged_sample(*on_dev, **kw).cpu(),
                           ref), (name, bilinear)

def _k2_inputs(cap, count, seed, n_meshlets=24):
    """Random K2 inputs (CPU): draws of random meshlets with random
    local->clip matrices whose w row puts some corners behind the eye,
    zero-area and collinear triangles, two-sided draws, triangle counts
    below 128; slots >= count are slack (meshlet = the poison window)."""
    rng = np.random.default_rng(seed)
    ncols = (n_meshlets + 1) * 128
    posT = rng.uniform(-1.0, 1.0, (12, ncols)).astype(np.float32)
    posT[3::4] = 1.0
    lanes = rng.random(ncols)
    posT[4:7, lanes < 0.1] = posT[0:3, lanes < 0.1]          # zero area
    mid = (lanes >= 0.1) & (lanes < 0.15)                     # collinear
    posT[8:11, mid] = 2.0 * posT[4:7, mid] - posT[0:3, mid]
    attrT = rng.uniform(-1.0, 1.0, (16, ncols)).astype(np.float32)
    live = np.arange(cap) < count
    dm = np.where(live, rng.integers(0, n_meshlets, cap), n_meshlets)
    tcnt = np.where(live, rng.choice([128, 127, 64, 1, 100], cap), 0)
    m = rng.normal(0.0, 1.0, (cap, 4, 4)).astype(np.float32)
    m[:, 3, 3] = rng.uniform(0.5, 3.0, cap)    # w: cw in about [-3, 6]
    mats = np.concatenate([m.reshape(cap, 16),
                           rng.normal(0.0, 1.0, (cap, 9)),
                           (rng.random((cap, 1)) < 0.5)], 1)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt))
    return (t(dm, np.int32), t(tcnt, np.int32),
            t(np.array([count]), np.int32), t(mats, np.float32),
            t(posT, np.float32), t(attrT, np.float32))


@pytest.mark.cuda
def test_mesh_shader_random_inputs(dev):
    """K2 against mesh_shader_plain at tolerance 0: count 0, 1, cap - 1 and
    cap; corners behind the eye, degenerate triangles, two-sided draws,
    triangle counts below 128; without the sort, without back-face
    culling and with a payload base."""
    cap = 48
    for count in (0, 1, cap - 1, cap):
        args = _k2_inputs(cap, count, seed=11 + count)
        for kw in (dict(), dict(sort_tris=False),
                   dict(backface_cull=False, payload_base=37)):
            ref = mesh_shader.mesh_shader_plain(*args, 96, 64, **kw)
            got = mesh_shader.mesh_shader(*[a.to(dev) for a in args], 96, 64,
                                          **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), ref[0]), (count, kw)
            assert torch.equal(got[1].cpu().view(torch.int32),
                               ref[1].view(torch.int32)), (count, kw)
            if count >= cap - 1:
                n_valid = int(ref[1][0].sum())
                assert 0.05 * count * 128 < n_valid < count * 128, n_valid


@pytest.mark.cuda
def test_raster_variants_match_plain(dev):
    """z_clip and depth-only rasters (not on the `off` path)."""
    pools, inst, views, hist = _sequence(dev, frames=1)
    with kernels.capture_inputs() as captured:
        render_sequence_meshlet(pools, inst, views, hist, CFG, MCFG)
    k = kernels.KERNELS[0]
    args, _ = captured["raster"][-1]
    pair_win, starts, counts, sb, coefT, seeds, _z, c = args
    zclip = torch.where(seeds[0] > 0, seeds[0] * 1.0001,
                        torch.full_like(seeds[0], 3e38))
    _exact(k, (pair_win, starts, counts, sb, coefT, seeds, zclip,
               c._replace(z_clip=True)), {})
    _exact(k, (pair_win, starts, counts, sb, coefT, seeds[:2], None,
               c._replace(with_attrs=False)), {})


@pytest.mark.cuda
def test_peel_raster_matches_plain(dev):
    """K1 as the masked depth peel calls it (z-clip plane and attributes)
    on a frame's real masked queue: the small textured bistro at render
    size with masked_layers=2; the peel's call is the one with a z-clip
    plane, padded to the tile grid with 3e38."""
    pools, inst, views, hist = _tex_sequence(dev, frames=2, native=True)
    with kernels.capture_inputs() as captured:
        render_sequence_meshlet(pools, inst, views, hist, NATIVE_CFG,
                                NATIVE_MCFG)
    k = kernels.KERNELS[0]
    peel = [(a, kw) for a, kw in captured["raster"] if a[6] is not None]
    assert len(peel) == 2
    for args, kwargs in peel:
        c, zq = args[7], args[6]
        assert c.z_clip and c.with_attrs
        assert zq.shape == (c.tiles_y * c.tile_h, c.tiles_x * c.tile_w)
        assert bool((zq[H:] == 3e38).all()) and bool((zq[:, W:] == 3e38).all())
        _exact(k, args, kwargs)


@pytest.mark.cuda
def test_gather_and_reproject_random_inputs(dev):
    rng = np.random.default_rng(0)
    n = 2560
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (16, n),
                                          dtype=np.int64).astype(np.int32))
    slot = torch.from_numpy(rng.integers(-5, n + 50, (720, 1280),
                                         dtype=np.int64).astype(np.int32))
    got = row_gather.gather_rows(table.to(dev), slot.to(dev))
    assert torch.equal(got.cpu(), row_gather.gather_rows_plain(table, slot))

    img = torch.from_numpy(rng.uniform(0, 2, (1080, 1920, 3)).astype(
        np.float32))
    mot = torch.from_numpy(rng.normal(0, 20, (1080, 1920, 2)).astype(
        np.float32))
    with kernels.capture_inputs() as captured:
        tile_reproject.tile_reproject(img.to(dev), mot.to(dev))
    args, kwargs = captured["tile_reproject"][0]
    _exact(kernels.KERNELS[3], args, kwargs)



@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,scale", [
    (1080, 1920, 3, 20.0),    # the TSR history at post res
    (360, 640, 3, 8.0),       # the half-res GI diffuse history
    (90, 330, 3, 400.0),      # no multiple of 32x128; starts past -MARGIN
    (64, 200, 1, 150.0),      # one channel, past the right edge too
])
def test_tile_reproject_kernel_route_equals_plain_route(dev, h, w, c, scale):
    """The public tile_reproject with CUDA tensors (K4) equals the same
    call routed through reproject_tiles_plain on the card, bit for bit:
    the kernel's clamped coordinates against the plain version's padded
    planes, at the bench's two shapes and at ragged, clamping ones."""
    rng = np.random.default_rng(h + w)
    img = torch.from_numpy(rng.uniform(0, 2, (h, w, c)).astype(
        np.float32)).to(dev)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mot = np.stack([np.sin(xx / 37.0) * scale + 0.3 * scale,
                    np.cos(yy / 23.0) * scale - 0.2 * scale], -1)
    mot = torch.from_numpy((mot + rng.normal(0, 0.3, (h, w, 2))).astype(
        np.float32)).to(dev)
    if c == 1:
        img = img[..., 0]
    n = tile_reproject.reproject_tiles.launches
    got = tile_reproject.tile_reproject(img, mot)
    assert tile_reproject.reproject_tiles.launches == n + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tile_reproject, "reproject_tiles",
                   tile_reproject.reproject_tiles_plain)
        ref = tile_reproject.tile_reproject(img, mot)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert kernels.max_abs_err([a], [b.contiguous()]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 875, rt.DENSE_LEAF_LIMIT + 1])
def test_rt_trace_matches_cpu(dev, n):
    """rt.trace on the card (dense up to DENSE_LEAF_LIMIT leaves, the
    BVH scan above) against the CPU on the same BVH: leaf ids equal on the
    rays no rounding can flip (rt_cases.decided's margins), t within
    1e-3 relative + 1e-3 absolute: cuBLAS sums the 3-term dots in its own
    order, and the dense path's |o|^2 - 2 o.c + |c|^2 cancels at scene
    coordinates near 25 (tests/test_torch_rt.py holds the dense path to
    its oracle at the same bound; measured 2.9e-4 relative on the H100)."""
    sph = rt_cases.spheres(n, seed=n)
    o, d = rt_cases.rays(4096 if n < 1000 else 1024, seed=n + 1)
    keep = rt_cases.decided(o, d, sph)
    bvh = rt_cases.port_bvh(bvh_build(sph), sph)
    cpu = rt.trace(torch.from_numpy(o), torch.from_numpy(d), bvh)
    gpu = rt.trace(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                   rt.SceneBVH(*(None if x is None else x.to(dev)
                                 for x in bvh)))
    t, leaf = (x.cpu().numpy() for x in gpu)
    np.testing.assert_array_equal(leaf[keep], cpu[1].numpy()[keep])
    hit = keep & (leaf >= 0)
    assert hit.sum() > 50
    np.testing.assert_allclose(t[hit], cpu[0].numpy()[hit], rtol=1e-3,
                               atol=1e-3)

@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, rt.DENSE_TRI_LIMIT + 1])
def test_rt_trace_triangles_matches_cpu(dev, n):
    """rt.trace on a triangle BVH on the card (trace_dense_tri up to
    DENSE_TRI_LIMIT triangles, the scan with triangle leaves above)
    against the CPU: leaf ids equal on the rays rt_cases.tri_decided
    keeps, t within 1e-4 relative + 1e-4 absolute (cuBLAS orders the
    3-term dots its own way)."""
    v0, e1, e2 = rt_cases.triangles(n, seed=n)
    o, d = rt_cases.tri_rays(v0, e1, e2, 2048 if n < 1000 else 512,
                             seed=n + 1)
    keep = rt_cases.tri_decided(o, d, v0, e1, e2)
    bvh, _ = rt_cases.tri_bvh(v0, e1, e2)
    calls = rt.trace.dense
    cpu = rt.trace(torch.from_numpy(o), torch.from_numpy(d), bvh)
    gpu = rt.trace(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                   rt.SceneBVH(*(None if x is None else x.to(dev)
                                 for x in bvh)))
    assert rt.trace.dense - calls == (2 if n <= rt.DENSE_TRI_LIMIT else 0)
    t, leaf = (x.cpu().numpy() for x in gpu)
    np.testing.assert_array_equal(leaf[keep], cpu[1].numpy()[keep])
    hit = keep & (leaf >= 0)
    assert hit.sum() > 50
    np.testing.assert_allclose(t[hit], cpu[0].numpy()[hit], rtol=1e-4,
                               atol=1e-4)


def _pcss_inputs(d, n=4, r=1024, h=90, w=160, seed=7):
    """K6 at its bench shapes: a random stack (zeros = empty texels) and a
    random prepass, edge and out-of-map taps included."""
    rng = np.random.default_rng(seed)
    maps = rng.uniform(0.0, 1.0, (n, r, r)).astype(np.float32)
    maps[rng.uniform(size=maps.shape) < 0.4] = 0.0
    f = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(
        np.float32)).to(d)
    theta = f(0.0, 2 * np.pi)
    z = f(0.0, 1.0)
    pre = shadow.ShadowPrepass(
        cascade=torch.from_numpy(rng.integers(-1, n, (h, w)).astype(
            np.int32)).to(d),
        u=f(-8.0, r + 8.0), v=f(-8.0, r + 8.0), z_cmp=z + f(0.0, 2e-3),
        z_recv=z, ca=torch.cos(theta), sa=torch.sin(theta),
        depth_range=torch.from_numpy(rng.uniform(5, 500, n).astype(
            np.float32)).to(d),
        texel=torch.from_numpy(rng.uniform(0.01, 0.5, n).astype(
            np.float32)).to(d))
    return torch.from_numpy(maps).to(d), pre


@pytest.mark.cuda
def test_pcss_random_inputs(dev):
    """K6 against its plain version on the card and on the CPU (bench
    shapes, random stack and prepass), bit for bit; eval_kernel=False has
    no path on the card."""
    maps, pre = _pcss_inputs(dev)
    cfg = shadow.ShadowConfig()
    got = shadow_kernel.pcss(maps, pre, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, shadow.pcss_plain(maps, pre, cfg))
    cpu = shadow.pcss_plain(maps.cpu(), shadow.ShadowPrepass(
        *[x.cpu() for x in pre]), cfg)
    assert torch.equal(got.cpu(), cpu)
    assert 0.0 < float((got < 1.0).float().mean()) < 1.0
    with pytest.raises(NotImplementedError):
        shadow.evaluate_shadow_auto(
            torch.zeros((4, 4, 3), device=dev), torch.zeros((4, 4, 3),
                                                            device=dev),
            torch.ones(3, device=dev), maps, torch.zeros((4, 4, 4),
                                                         device=dev),
            cfg._replace(eval_kernel=False))


def _pcss_exact(maps, pre, cfg):
    """K6 against its plain version on the card and on the CPU, bit for
    bit -> the kernel's output."""
    got = shadow_kernel.pcss(maps, pre, cfg)
    torch.cuda.synchronize()
    cpu = shadow.pcss_plain(maps.cpu(), shadow.ShadowPrepass(
        *[x.cpu() for x in pre]), cfg)
    for ref in (shadow.pcss_plain(maps, pre, cfg), cpu):
        assert kernels.max_abs_err([got.cpu()], [ref.cpu()]) == 0.0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [(5, 6), (1, 1), (16, 16), (3, 7)])
def test_pcss_tap_counts(dev, counts):
    """K6's bench instance (5 blocker, 6 PCF taps: counts fixed at compile
    time) and the generic one (every other count in [1, 16])."""
    maps, pre = _pcss_inputs(dev)
    cfg = shadow.ShadowConfig(pcss_blocker_samples=counts[0],
                              pcss_pcf_samples=counts[1])
    got = _pcss_exact(maps, pre, cfg)
    assert 0.0 < float((got < 1.0).float().mean()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd_size", "all_outside", "past_edges",
                                  "radius_at_1", "radius_at_max"])
def test_pcss_edge_cases(dev, case):
    """K6 on an eval grid that is no multiple of a block (7x13), with every
    pixel outside the cascades, with taps past every edge of the map, and
    with every PCF radius clamped at 1 or at PCF_RADIUS_MAX; the bench's
    tap counts and a generic count."""
    h, w = (7, 13) if case == "odd_size" else (90, 160)
    maps, pre = _pcss_inputs(dev, h=h, w=w)
    cfg = shadow.ShadowConfig()
    r = maps.shape[-1]
    if case == "all_outside":
        pre = pre._replace(cascade=torch.full_like(pre.cascade, -1))
    if case == "past_edges":
        # each pixel beyond one edge, or two (a corner), by up to 200
        # texels: every tap clamps to the map's border
        g = torch.Generator(device="cpu").manual_seed(3)
        su = torch.randint(0, 3, (h, w), generator=g)    # 2: inside
        sv = torch.where(su == 2, torch.randint(0, 2, (h, w), generator=g),
                         torch.randint(0, 3, (h, w), generator=g))
        off = torch.rand((2, h, w), generator=g).to(dev) * 200 + 40
        u, v = (torch.where(sd == 0, -off[i], torch.where(
            sd == 1, r + off[i], p)) for i, (sd, p) in
            enumerate(zip((su.to(dev), sv.to(dev)), (pre.u, pre.v))))
        pre = pre._replace(u=u, v=v)
    if case == "radius_at_1":
        cfg = cfg._replace(pcf_radius_px=0.25, light_size_world=0.0)
    if case == "radius_at_max":
        cfg = cfg._replace(light_size_world=1e4)
    for c in (cfg, cfg._replace(pcss_blocker_samples=4, pcss_pcf_samples=9)):
        got = _pcss_exact(maps, pre, c)
        inside = pre.cascade >= 0
        rad = shadow.pcf_radius(maps, pre, c)[inside]
        if case == "all_outside":
            assert bool((got == 1.0).all())
        if case == "radius_at_1":
            assert bool((rad == 1.0).all())
        if case == "radius_at_max":
            assert float((rad == shadow.PCF_RADIUS_MAX).float().mean()) > 0.5
        if case == "past_edges":
            assert bool(((u < 0) | (u >= r) | (v < 0) | (v >= r)).all())


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(dev):
    table = torch.zeros((16, 8), dtype=torch.float32, device=dev)
    slot = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        row_gather.gather_rows(table, slot)
    tab = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    img = torch.zeros((10, 10, 3), device=dev)
    for bad_img, bad_tab in ((img, tab[:0]), (img.double(), tab),
                             (img.transpose(0, 1), tab),
                             (torch.zeros((10, 10, 9), device=dev), tab),
                             (img[..., 0], tab), (img, tab.float())):
        with pytest.raises(ValueError):
            tile_reproject.reproject_tiles(bad_img, bad_tab)
    pages = torch.zeros((16, 128), dtype=torch.int32, device=dev)
    meta = torch.zeros((3, 128), dtype=torch.int32, device=dev)
    layers = torch.zeros((2, 4, 4), dtype=torch.int32, device=dev)
    uv = torch.zeros((4, 4, 2), device=dev)
    for bad in (dict(meta=meta[:1]), dict(pages=pages[:, :64]),
                dict(layers=layers.float()), dict(uv=uv[..., :1]),
                dict(mip=slot.float()), dict(n_mips=17),
                dict(uv=uv.transpose(0, 1)), dict(block_h=8),
                dict(k_pages=17), dict(k_pages=0),
                dict(layers=torch.zeros((5, 4, 4), dtype=torch.int32,
                                        device=dev))):
        a = dict(pages=pages, meta=meta, n_mips=2, mip_sizes=(2, 1),
                 layers=layers, uv=uv, mip=slot)
        a.update(bad)
        with pytest.raises(ValueError):
            paged_texture.paged_sample(**a)
    maps, pre = _pcss_inputs(dev, n=2, r=64, h=4, w=4)
    for bad in (dict(u=pre.u.double()), dict(cascade=pre.cascade.float()),
                dict(texel=pre.texel[:1]), dict(v=pre.v[:, :2])):
        with pytest.raises(ValueError):
            shadow_kernel.pcss(maps, pre._replace(**bad),
                               shadow.ShadowConfig())
    with pytest.raises(ValueError):
        shadow_kernel.pcss(maps[:, :, :32], pre, shadow.ShadowConfig())
    # the brick raster needs tile_h % (4*sub_s) == 0, K7 a bricks config,
    # K8 a 128-px tile; the flat frame takes a process group (`group=`),
    # not chord_tpu's named axis
    setup = raster.TriangleSetup(coefT=table, window_bbox=slot,
                                 window_valid=slot, valid=slot)
    with pytest.raises(ValueError):
        raster.raster_queue(None, setup, raster.RasterConfig(
            width=8, height=8, tile_h=24, sub_s=4, bricks=True))
    k7_args = _brick_inputs(dev, attrs=False)
    with pytest.raises(ValueError):
        raster.raster_bricks(*k7_args[:-1], k7_args[-1]._replace(
            bricks=False))
    k8_args = _subtile_inputs(dev, attrs=False)
    with pytest.raises(ValueError):
        raster.raster_subtile(*k8_args[:-1], k8_args[-1]._replace(
            tile_w=64))
    with pytest.raises(ValueError):   # a seed plane missing
        raster.raster_subtile(*k8_args[:-2], k8_args[-2][:1], k8_args[-1])
    b = build_sponza_like(detail=1)
    cam = Camera(width=W, height=H)
    # K10: H % 32, W % 128, dtypes, pool rows % 8, meta (4, 128); K9:
    # contiguous CUDA tensors only
    pool, meta, u, v, lm = _proto_inputs(dev, 64, 256)
    for bad in (dict(u=u[:48], v=v[:48], lm=lm[:48]),
                dict(u=u[:, :192], v=v[:, :192], lm=lm[:, :192]),
                dict(u=u.double()), dict(v=v.half()), dict(lm=lm.long()),
                dict(lm=lm.float()), dict(pool=pool[:12]),
                dict(pool=pool.float()), dict(meta=meta[:3]),
                dict(meta=meta[:, :64]), dict(u=u.t().contiguous().t())):
        a = dict(pool=pool, meta=meta, u=u, v=v, lm=lm)
        a.update(bad)
        with pytest.raises(ValueError):
            proto_sampler.paged_sample(**a)
    with pytest.raises(ValueError):      # a CPU tensor into the kernel
        proto_sampler.paged_sample(pool.cpu(), meta, u, v, lm)
    x = torch.zeros((8, 6), device=dev)
    with pytest.raises(ValueError):
        fusion_barrier.fusion_barrier(x.t())
    with pytest.raises(ValueError):
        fusion_barrier.copy_cuda(x.cpu())
    with pytest.raises(TypeError, match="axis_name"):
        render_frame_flat(b.build_pools(device=dev),
                          b.frame_instances(cam, device=dev),
                          DeviceView.from_uniform(cam.view_uniform(0),
                                                  device=dev),
                          FrameHistory.empty(H, W, device=dev), FLAT_CFG,
                          axis_name="x")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["off", "geo_tex", "geo_shadow_atmo",
                                  "geo_tex_bricks", "flat", "all_no_rt",
                                  "all", "all_ddgi", "all_exact",
                                  "geo_tex_native", "off_no_occlusion",
                                  "geo_shadow_atmo_split", "interior",
                                  "nanite"])
def test_gpu_frames_match_cpu_plain(dev, path):
    """The tiny sequence of each path through the kernels on the GPU equals
    the plain versions on the CPU (the path the CPU tests hold against
    chord_tpu): stats exactly, images within 2 u8 levels on >= 99.9% of
    values."""
    out = {}
    for d in (dev, torch.device("cpu")):
        imgs, st = _render_path(path, d)
        out[d.type] = (imgs.cpu().numpy().astype(np.int32), st)
    assert out["cuda"][1] == out["cpu"][1]
    if path not in ("off", "flat", "off_no_occlusion", "interior",
                    "nanite"):
        assert max(out["cuda"][1]["draws_masked"]) > 0
    diff = np.abs(out["cuda"][0] - out["cpu"][0])
    assert (diff <= 2).mean() >= 0.999, diff.max()


@pytest.mark.cuda
def test_gi_cache_scatter_is_deterministic(dev):
    """The world-cache splat (index_put_ with accumulate, which PyTorch
    sorts on CUDA) gives the same cache bit for bit on every run, and the
    CPU's within 1e-6 relative, with thousands of surfels per probe."""
    rng = np.random.default_rng(11)
    cfg = GIConfig(cascades=2, probe_dim=8)
    n = 1 << 16
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    flat = rng.normal(size=(n, gi.NFL)).astype(np.float32)
    ok = rng.uniform(size=n) < 0.9
    cache = rng.normal(size=gi.sh_size(cfg)).astype(np.float32)
    outs = {}
    for d in (dev, dev, torch.device("cpu")):
        t = lambda a: torch.from_numpy(a).to(d)
        out = gi.splat_cascade(t(cache), 1, t(pos), t(flat), t(ok), cfg,
                               0.12, torch.zeros(3, device=d))
        outs.setdefault(d.type, []).append(out.cpu().numpy())
    np.testing.assert_array_equal(outs["cuda"][0], outs["cuda"][1])
    np.testing.assert_allclose(outs["cuda"][0], outs["cpu"][0], rtol=1e-6,
                               atol=1e-6)


def _rand_setup(rng, d, n_win, w, h, attrs):
    """A random TriangleSetup of n_win windows of random triangles spread
    over a (h, w) screen (some windows empty), with the port's own
    setup_triangles."""
    n = n_win * 128
    clip = np.zeros((n * 3, 4), np.float32)
    cen = rng.uniform(-1.1, 1.1, (n, 2))
    cen = cen[np.argsort(np.floor(cen[:, 1] * 4) * 8 + cen[:, 0])]
    pts = cen[:, None, :] + rng.uniform(-0.2, 0.2, (n, 3, 2))
    wv = rng.uniform(0.6, 2.5, (n, 3))
    clip[:, 0:2] = (pts * wv[..., None]).reshape(-1, 2)
    clip[:, 2] = (rng.uniform(0.1, 0.9, (n, 1)) * wv).reshape(-1)
    clip[:, 3] = wv.reshape(-1)
    valid = rng.uniform(size=n) < 0.9
    valid[128:256] = False                     # an empty window
    c = raster.RasterConfig(width=w, height=h, tile_h=32, sub_s=8,
                            with_attrs=attrs, pair_capacity=2048,
                            big_capacity=32)
    t = lambda a: torch.from_numpy(a).to(d)
    setup = raster.setup_triangles(
        t(clip), t(np.arange(n * 3, dtype=np.int32).reshape(n, 3)), t(valid),
        t(np.arange(1, n + 1, dtype=np.int32)), c, backface_cull=False,
        attrs=t(rng.normal(size=(n * 3, 5)).astype(np.float32)))
    return setup, c


def _seed_planes(rng, d, c, n):
    """Random seed planes: depth in [0, 0.5) with holes, vis ids."""
    h_pad, w_pad = c.tiles_y * c.tile_h, c.tiles_x * c.tile_w
    dep = rng.uniform(0, 0.5, (h_pad, w_pad)).astype(np.float32)
    dep[rng.uniform(size=dep.shape) < 0.5] = 0.0
    seeds = [dep, rng.integers(0, 1 << 20, (h_pad, w_pad)).astype(np.int32)]
    seeds += [rng.normal(size=(h_pad, w_pad)).astype(np.float32)
              for _ in range(n - 2)]
    return [torch.from_numpy(x).to(d) for x in seeds]


def _brick_inputs(d, attrs=True, seeded=False, zclip=False, seed=3):
    rng = np.random.default_rng(seed)
    setup, c = _rand_setup(rng, d, 6, 256, 96, attrs)
    c = c._replace(bricks=True, z_clip=zclip)
    q = raster.bin_windows(setup, c)
    n = 7 if attrs else 2
    seeds = (_seed_planes(rng, d, c, n) if seeded else
             raster._seed_planes(None, c, d))
    zc = None
    if zclip:
        zc = torch.from_numpy(rng.uniform(0.2, 1.0, seeds[0].shape).astype(
            np.float32)).to(d)
    return (q.pair_win, q.starts, q.counts, setup.sub_bounds, setup.coefT,
            seeds, zc, c)


def _subtile_inputs(d, attrs=True, seeded=False, seed=4):
    rng = np.random.default_rng(seed)
    setup, c = _rand_setup(rng, d, 6, 256, 96, attrs)
    c = c._replace(subtiles=True, tile_h=24)
    q = raster.bin_windows_subtile(setup, c)
    seeds = (_seed_planes(rng, d, c, 7 if attrs else 2) if seeded else
             raster._seed_planes(None, c, d))
    return (q.gwin, q.starts, q.counts, q.y0r, q.y1r, setup.coefT, seeds, c)


@pytest.mark.cuda
@pytest.mark.parametrize("attrs,seeded,zclip", [(True, False, False),
                                                (True, True, True),
                                                (False, True, False)])
def test_brick_and_subtile_rasters_random_inputs(dev, attrs, seeded, zclip):
    """K7 and K8 against their plain versions on the card and on the CPU:
    random perspective triangles on 256x96 (6 tiles; an empty window,
    poison slots in the sub-tile rounds, empty tiles at the edges), with
    and without attributes, random seeds, a z_clip plane (K7)."""
    k7 = next(k for k in kernels.KERNELS if k.name == "raster_bricks")
    k8 = next(k for k in kernels.KERNELS if k.name == "raster_subtile")
    for k, args in ((k7, _brick_inputs(dev, attrs, seeded, zclip)),
                    (k8, _subtile_inputs(dev, attrs, seeded))):
        _exact(k, args, {})
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else
               [x.cpu() for x in a] if isinstance(a, list) else a
               for a in args]
        got = kernels.outputs_list(k.fn()(*args))
        ref = kernels.outputs_list(k.plain(*cpu))
        assert kernels.max_abs_err([g.cpu() for g in got], ref) == 0.0
        assert float((got[0] > 0).float().mean()) > 0.2
    gw = args[0].view(-1, 4)
    assert (gw == args[5].shape[0] // 128 - 1).any()   # poison slots


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kernel,scene,attrs,tile_h,sub_s,rp,zclip",
    BAND_CASES + [("k1", "imbalance", True, 32, 8, 16, True),
                  ("k1", "ties", False, 16, 4, 8, False),
                  ("k8", "negative", True, 24, 8, 0, False),
                  ("k8", "imbalance", False, 40, 8, 0, False),
                  ("k7", "random", False, 96, 8, 0, True),
                  ("k7", "ties", False, 16, 4, 0, True),
                  ("k7", "negative", True, 32, 8, 0, False),
                  ("k7", "straddle", False, 64, 8, 0, False),
                  # K1 and K8 on the plane policy K7 shares with them
                  ("k1", "straddle", False, 48, 8, 0, False),
                  ("k8", "random", False, 96, 8, 0, False)])
def test_raster_band_cases(dev, kernel, scene, attrs, tile_h, sub_s, rp,
                           zclip):
    """K1, K7 and K8's block decomposition (32 columns x a band of rows
    per block, the corner cull) against their plain versions on the card
    and on the CPU, bit for bit: one tile holding nearly every pair beside
    empty tiles, tall windows over every band boundary, exact depth ties
    within groups and across visits, signed payloads and seeds (a visit
    that covers nothing still replaces a (0, < 0) seed), n_attr 0 and 5;
    K1 with z_clip, rp != sub_s and 32- or 64-triangle groups; K7 in its
    plane association, with z_clip, sub_s 4 and 8 (row groups of 16 and
    32 over 8-row bands) and tile_h 16 to 96; K8 with poison slots and
    tile_h 24, 40, 72 and 96 (3 to 12 bands a tile: tile_h is a multiple
    of 8, so no band is partial)."""
    name = {"k1": "raster", "k7": "raster_bricks",
            "k8": "raster_subtile"}[kernel]
    k = next(k for k in kernels.KERNELS if k.name == name)
    args = band_inputs(dev, kernel, scene, attrs, tile_h, sub_s, rp, zclip)
    _exact(k, args, {})
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else
           [x.cpu() for x in a] if isinstance(a, list) else a for a in args]
    got = kernels.outputs_list(k.fn()(*args))
    ref = kernels.outputs_list(k.plain(*cpu))
    assert kernels.max_abs_err([g.cpu() for g in got], ref) == 0.0
    assert float((got[0] > 0).float().mean()) > 0.1
    if kernel == "k8":
        assert (args[0].view(-1, 4) == args[5].shape[0] // 128 - 1).any()


@pytest.mark.cuda
def test_band_constants_match_the_kernels(dev):
    """raster.K1_BAND, K7_BAND, K8_BAND and WARP_ROWS, which the band rule,
    the work stats and the cull count read, are the kernels' own
    constants."""
    lib = _cuda.lib()
    assert lib.chord_raster_tiles_band() == raster.K1_BAND == raster.WARP_ROWS
    assert lib.chord_raster_bricks_band() == raster.K7_BAND
    assert lib.chord_raster_subtile_band() == raster.K8_BAND
    assert lib.chord_raster_subtile_rows() == raster.WARP_ROWS


def _proto_inputs(d, h, w, seed=6):
    """K10's inputs: the tool's 36-entry pool, random uv in [-2, 3)
    (negative coordinates and partial coverage) and lm in [-1, 36)."""
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 255, (s, s, 4)).astype(np.uint8)
              for _ in range(4) for s in (256, 128, 64, 32, 16, 8, 4, 2, 1)]
    pool, meta = proto_paged_tex.build_tiled_pool(images)
    f = lambda a: torch.from_numpy(a).to(d)
    return (f(pool), f(meta),
            f(rng.uniform(-2, 3, (h, w)).astype(np.float32)),
            f(rng.uniform(-2, 3, (h, w)).astype(np.float32)),
            f(rng.integers(-1, 36, (h, w)).astype(np.int32)))


@pytest.mark.cuda
def test_sincos_random_inputs(dev):
    """The sincos kernel against its plain version on the card and on the
    CPU, bit for bit: seeded angles of every range (the fast reduction
    below 120, the integer one above, tiny, denormal, huge), a few
    thousand f32 on each side of the multiples of pi/2 below 120, 0, -0,
    inf and NaN; shapes kept, one launch a call, none for an empty
    tensor; a non-contiguous or non-f32 tensor raises."""
    rng = np.random.default_rng(23)
    near = [np.arange(-3000, 3000) + np.float32(k * np.pi / 2).view(np.int32)
            for k in range(1, 77)]
    x = np.concatenate([
        rng.uniform(-120, 120, 1 << 20), rng.uniform(-1, 1, 1 << 16),
        10 ** rng.uniform(-45, 38.5, 1 << 16) * rng.choice([-1, 1], 1 << 16),
        np.concatenate(near).astype(np.int32).view(np.float32),
        [0.0, -0.0, np.inf, -np.inf, np.nan]]).astype(np.float32)
    x = np.concatenate([x, -x])
    t = torch.from_numpy(x).to(dev).reshape(2, -1)
    before = _util.sincosf.launches
    got = _util.sincosf(t)
    torch.cuda.synchronize()
    assert _util.sincosf.launches == before + 1
    for ref in (_util.sincosf_plain(t), _util.sincosf_plain(t.cpu())):
        for g, r in zip(got, ref):
            assert g.shape == t.shape and g.dtype == torch.float32
            assert torch.equal(g.cpu().view(torch.int32),
                               r.cpu().view(torch.int32))
    empty = _util.sincosf(torch.empty((0, 3), device=dev))
    assert empty[0].shape == (0, 3) and _util.sincosf.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        _util.sincosf(t[:, ::2])
    with pytest.raises(ValueError):
        _util.sincosf(t.double())


@pytest.mark.cuda
def test_powf_random_inputs(dev):
    """The powf kernel against its plain version on the card and on the
    CPU, bit for bit: seeded bases in [0, 1] (the edge weights'), tiny
    ones whose power flushes to 0, large ones, 0, 1, subnormal, inf, NaN
    and a negative base, for the edge weight's exponent 8 and others;
    shapes kept, one launch a call, none for an empty tensor; a
    non-contiguous or non-f32 tensor raises."""
    rng = np.random.default_rng(24)
    x = np.concatenate([
        rng.random(1 << 20), rng.random(1 << 14) ** 40,
        rng.uniform(1, 300, 1 << 14),
        [0.0, 1.0, 1e-45, 2.0 ** -126, np.inf, np.nan, -0.5]]).astype(
            np.float32)
    t = torch.from_numpy(x).to(dev).reshape(1, -1)
    for y in (8.0, 0.5, 2.5, 16.0):
        before = _util.powf.launches
        got = _util.powf(t, y)
        torch.cuda.synchronize()
        assert _util.powf.launches == before + 1
        for ref in (_util.powf_plain(t, y), _util.powf_plain(t.cpu(), y)):
            assert got.shape == t.shape and got.dtype == torch.float32
            assert torch.equal(got.cpu().view(torch.int32),
                               ref.cpu().view(torch.int32))
    before = _util.powf.launches
    empty = _util.powf(torch.empty((0, 3), device=dev), 8.0)
    assert empty.shape == (0, 3) and _util.powf.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        _util.powf(t[:, ::2], 8.0)
    with pytest.raises(ValueError):
        _util.powf(t.double(), 8.0)


@pytest.mark.cuda
def test_fusion_barrier_random_inputs(dev):
    """K9 against x.clone(), byte for byte, on every dtype and on byte
    counts and offsets that leave a scalar tail or an unaligned buffer; the
    result never aliases its input; an empty tensor launches nothing."""
    rng = np.random.default_rng(8)
    raw = torch.from_numpy(rng.integers(0, 256, 1 << 20, dtype=np.int64)
                           .astype(np.uint8)).to(dev)
    cases = [raw[:135 * 240 * 4].view(torch.float32).view(135, 240),
             raw[:4 * 7].view(torch.int32), raw[:30].view(3, 5, 2),
             raw[:100] > 127, raw[3:3 + 1001], raw[:(1 << 20) - 5],
             raw.view(torch.int32)]
    for x in cases:
        before = fusion_barrier.fusion_barrier.launches
        got = fusion_barrier.fusion_barrier(x)
        torch.cuda.synchronize()
        assert fusion_barrier.fusion_barrier.launches == before + 1
        assert got.shape == x.shape and got.dtype == x.dtype
        assert got.data_ptr() != x.data_ptr()
        assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))
    before = fusion_barrier.fusion_barrier.launches
    empty = fusion_barrier.fusion_barrier(torch.empty((0, 4), device=dev))
    assert empty.shape == (0, 4)
    assert fusion_barrier.fusion_barrier.launches == before


@pytest.mark.cuda
def test_proto_sampler_random_inputs(dev):
    """K10 against its plain version on the card and on the CPU, bit for
    bit: random uv (negative too), untextured pixels, partial coverage;
    then the tool's own coherent field through main() at full size."""
    args = _proto_inputs(dev, 1056, 1920)
    got = proto_sampler.paged_sample(*args)
    torch.cuda.synchronize()
    for ref in (proto_sampler.paged_sample_plain(*args),
                proto_sampler.paged_sample_plain(*[a.cpu() for a in args])):
        assert torch.equal(got[0].cpu(), ref[0].cpu())
        assert torch.equal(got[1].cpu(), ref[1].cpu())
    lm = args[4]
    assert torch.equal(got[0][lm < 0], torch.full_like(got[0][lm < 0], -1))
    served = got[1][lm >= 0].float().mean()
    assert 0.0 < float(served) < 1.0
    res = proto_paged_tex.main(device=dev)
    assert res["match"] == 1.0 and res["untextured_ok"]


def _proto_exact(args):
    """K10 against its plain version on the card and on the CPU, bit for
    bit -> the kernel's (out, cov)."""
    got = proto_sampler.paged_sample(*args)
    torch.cuda.synchronize()
    for ref in (proto_sampler.paged_sample_plain(*args),
                proto_sampler.paged_sample_plain(*[a.cpu() for a in args])):
        assert torch.equal(got[0].cpu(), ref[0].cpu())
        assert torch.equal(got[1].cpu(), ref[1].cpu())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(tile_cases(np.random.default_rng(0))))
def test_proto_sampler_palette_cases(dev, case):
    """K10 on the palette rule's cases (tests/proto_palette_cases.py):
    blocks asking for 1, 6, 7 and over 100 distinct tiles, duplicates
    across warps, untextured blocks, ids that clamp or reach BIG."""
    tiles = tile_cases(np.random.default_rng(0))[case]
    args = [torch.from_numpy(a).to(dev) for a in
            sampler_inputs(tiles, np.random.default_rng(1))]
    _, cov = _proto_exact(args)
    lm = args[4]
    assert bool((cov[lm < 0] == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nan_huge_uv", "one_tile_pool",
                                  "offset_views"])
def test_proto_sampler_edge_inputs(dev, case):
    """K10 with NaN, infinite and huge u, v; with a pool of one tile (every
    page clamps to it); and with inputs at an offset of one element (not
    16-B aligned: the kernel's 4-B path)."""
    pool, meta, u, v, lm = _proto_inputs(dev, 64, 256)
    if case == "nan_huge_uv":
        g = torch.Generator(device="cpu").manual_seed(5)
        special = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                1e30, -1e30, 2.0**24, -2.0**24 - 3, 1e-8,
                                -1e-8, -0.0])
        for x in (u, v):
            pick = torch.rand(x.shape, generator=g) < 0.3
            idx = torch.randint(0, len(special), x.shape, generator=g)
            x[pick.to(dev)] = special[idx][pick].to(dev)
    if case == "one_tile_pool":
        pool = pool[:8].clone()
    if case == "offset_views":
        def offset(x):
            buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=dev)
            buf[1:] = x.reshape(-1)
            return buf[1:].view(x.shape)
        u, v, lm = offset(u), offset(v), offset(lm)
        assert u.data_ptr() % 16 != 0
    _proto_exact((pool, meta, u, v, lm))


@pytest.mark.cuda
def test_tool_paths_launch_their_kernels(dev):
    """tm_pallas launches K9 once per call (1 + 3), no other variant
    launches it; each call's PCSS evaluate rotates its disk by the IGN
    noise through the sincos kernel (1 + 3), and no other kernel runs; the
    card's first call agrees with the CPU's."""
    for variant in ("tm_pallas", "tm_copy", "eval"):
        kernels.reset_launch_counts()
        res = repro_eval_kernel.run_variant(variant, dev)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts.pop("fusion_barrier") == (4 if variant == "tm_pallas"
                                                else 0)
        assert counts.pop("sincos") == 4
        assert not any(counts.values())
        run, a = repro_eval_kernel.build(variant, "cpu")
        cpu = run(*a, 1)
        d = (res["out"][0] - cpu).abs()
        assert float((d <= 1e-5).float().mean()) >= 0.999
