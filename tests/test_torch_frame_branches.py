"""The meshlet frame's other non-GI branches against chord_tpu, end to end.

Three frame cases through render_sequence_meshlet(with_stats=True), each
package building the scene with its own host code from the same seed
(chord_tpu's Pallas kernels in interpret mode, the port's plain versions):
- `no_occlusion_global_hdr10`: the tiny atrium of tests/test_torch_frame.py
  (3 frames, render 128x64 -> post 192x96) with occlusion=False (one cull,
  no HZB, one raster), object_precull=False (no active table, no
  active_* stats), global-mode TSR upscale and the HDR10 output;
- `no_tsr_upscale`: the same atrium, 2 frames, enable_tsr=False with the
  upscale (a nearest upsample in place of TSR);
- `masked_peel`: tests/test_torch_frame_tex.py's textured scene with three
  more leaf cards behind its three, seen from close by (so the leaves'
  alpha holes show texels of mip 0), one frame at render size 128x64 with
  masked_layers=2 (the depth peel: K1 with a
  z-clip plane and attributes, and a second alpha test), occlusion=False
  (the masked payload base is then `cap`, not cap + cap1) and gather-mode
  TSR without upscale; no blend bucket (chord_tpu's interpret-mode compile
  of this frame takes minutes, and the blend bucket is not what it holds).
Each frame's visibility buffer is caught where the gbuffer resolve reads
it, in both packages. Then `debug_visualize` at the function level, every
mode, on seeded buffers.

Tolerances: stats are integers and must match exactly, and so must the
visibility payloads (integers: the same triangle in the same draw slot);
images are u8 after the tonemap, where f32 rounding differences (XLA's
FMAs, pow / log2 ulps, the global TSR's 8192-term mean motion) move a value
a level or two, so >= 99.9% of channel values must lie within 2 levels.
debug_visualize is exact: integer hashes and palette look-ups, and one
rounding per float operation on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chord_tpu.asset.procedural as jproc
import chord_tpu.asset.texture as jtex
import chord_tpu.ops.paged_texture as jpt
import chord_tpu.ops.shading as jshading
import chord_tpu.renderer.meshlet_frame as jmf
import chord_tpu.rhi.scene_arrays as jsa
import chord_tpu.utils.math as jmath
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.rhi.framebuffer import FrameHistory as JHistory
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

import chord_tpu_torch.asset.procedural as proc
import chord_tpu_torch.asset.texture as tex
import chord_tpu_torch.ops.shading as tshading
import chord_tpu_torch.renderer.meshlet_frame as mf
import chord_tpu_torch.rhi.scene_arrays as sa
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      RendererConfig,
                                      render_sequence_meshlet)
from chord_tpu_torch.rhi.framebuffer import FrameHistory
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils import math as tmath
from chord_tpu_torch.utils.camera import Camera
from test_torch_frame import CFG, PH, PW, H, W, _path
from test_torch_frame_tex import MCFG as TEX_MCFG
from test_torch_frame_tex import build_textured_scene

CASES = {
    "no_occlusion_global_hdr10": dict(
        frames=3, textured=False,
        cfg={**CFG, "tsr_mode": "global", "output": "hdr10"},
        mcfg=dict(draw_capacity=1024, occlusion=False,
                  object_precull=False)),
    "no_tsr_upscale": dict(
        frames=2, textured=False, cfg={**CFG, "enable_tsr": False},
        mcfg=dict(draw_capacity=1024)),
    "masked_peel": dict(
        frames=1, textured=True,
        cfg=dict(width=W, height=H, pair_capacity=1024, big_capacity=64,
                 enable_bloom=True, enable_tsr=True, tsr_mode="gather"),
        mcfg={**TEX_MCFG, "masked_layers": 2, "occlusion": False,
              "alpha_blend": False}),
}


# the cases this file renders; `masked_peel` (chord_tpu's slowest compile
# here) renders in tests/test_torch_frame_branches_peel.py, so that a run
# that spreads test files over workers renders it beside the others
FILE_CASES = sorted(c for c in CASES if c != "masked_peel")


def peel_scene(procedural, scene_arrays, texture, cmath):
    """tests/test_torch_frame_tex.py's scene, with a second alpha-masked
    leaf card behind each of its three, shifted sideways, built with one
    package's host modules: where a front card's texel fails its alpha
    test, the peel finds the card behind."""
    b = build_textured_scene(procedural, scene_arrays, texture, cmath)
    leaf = next(i for i, m in enumerate(b.materials)
                if m.alpha_mode == "mask")
    card = next(mesh for mesh, mat, _ in b.instances if mat == leaf)
    pitch = cmath.compose_trs((0, 0, 0), rotation_quat=(
        np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)))
    for i in range(3):
        b.add_instance(card, leaf, pitch @ cmath.compose_trs(
            (-1.6 + 2.0 * i, 1.5, -3.8 + 0.5 * i), scale=(1.5, 1, 1.5)))
    return b


def peel_path(cam, n):
    """A jittered camera 3.5 units in front of the leaf cards."""
    for i in range(n):
        cam.position = np.array([0.2 * i, 1.6, 0.5])
        cam.look_at(np.array([0.0, 1.5, -3.0]))
        yield cam.view_uniform(i, jitter=True)


def _jax_vis_catcher(caught):
    orig = jshading.resolve_gbuffer_raster_rt

    def resolve(vis, *args, **kwargs):
        jax.debug.callback(lambda v: caught.append(np.asarray(v)), vis,
                           ordered=True)
        return orig(vis, *args, **kwargs)
    return resolve


def _torch_vis_catcher(caught):
    orig = tshading.resolve_gbuffer_raster_rt

    def resolve(vis, *args, **kwargs):
        caught.append(vis.numpy().view(np.uint32))
        return orig(vis, *args, **kwargs)
    return resolve


def _covered_sample(coverage):
    """chord_tpu's paged sampler with its page palette sized for the small
    textured scene (as tests/test_torch_frame_tex.py), reporting coverage:
    complete coverage means both packages compute the same function."""
    orig = jpt.paged_sample

    def sample(*args, **kwargs):
        kwargs.update(with_coverage=True,
                      k_pages=16 if args[4].shape[0] > 1 else 5)
        rgba, cov = orig(*args, **kwargs)
        jax.debug.callback(lambda m: coverage.append(float(m)), cov.min())
        return rgba
    return sample


def _run_jax(case):
    c = CASES[case]
    n = c["frames"]
    ph, pw = c["cfg"].get("post_height", H), c["cfg"].get("post_width", W)
    jcam = JCamera(width=W, height=H)
    if c["textured"]:
        jb = peel_scene(jproc, jsa, jtex, jmath)
        jviews = [JView.from_uniform(u) for u in peel_path(jcam, n)]
        pools = jax_pools(jb, texture_pool=jb.texture_pool)
    else:
        jb = jproc.build_sponza_like(detail=1)
        jviews = [JView.from_uniform(u) for u in _path(jcam)][:n]
        pools = jax_pools(jb)
    vis, coverage = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshading, "resolve_gbuffer_raster_rt",
                   _jax_vis_catcher(vis))
        mp.setattr(jpt, "paged_sample", _covered_sample(coverage))
        imgs, _, stats = jmf.render_sequence_meshlet(
            pools, jb.frame_instances(jcam),
            jax.tree.map(lambda *xs: jnp.stack(xs), *jviews),
            JHistory.empty(H, W, post_h=ph, post_w=pw),
            config=JConfig(**c["cfg"], interpret=True),
            mcfg=jmf.MeshletFrameConfig(**c["mcfg"]), with_stats=True)
        imgs = np.asarray(imgs)
        jax.effects_barrier()
    return imgs, {k: np.asarray(v) for k, v in stats.items()}, vis, coverage


def _run_torch(case, **mcfg_changes):
    c = CASES[case]
    n = c["frames"]
    ph, pw = c["cfg"].get("post_height", H), c["cfg"].get("post_width", W)
    cam = Camera(width=W, height=H)
    if c["textured"]:
        b = peel_scene(proc, sa, tex, tmath)
        us = list(peel_path(cam, n))
        pools = build_meshlet_pools(b, texture_pool=b.texture_pool,
                                    device="cpu")
    else:
        b = proc.build_sponza_like(detail=1)
        us = list(_path(cam))[:n]
        pools = build_meshlet_pools(b, device="cpu")
    views = DeviceView.stack([DeviceView.from_uniform(u, device="cpu")
                              for u in us])
    vis = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tshading, "resolve_gbuffer_raster_rt",
                   _torch_vis_catcher(vis))
        imgs, _, stats = render_sequence_meshlet(
            pools, b.frame_instances(cam, device="cpu"), views,
            FrameHistory.empty(H, W, ph, pw, device="cpu"),
            RendererConfig(**c["cfg"]),
            MeshletFrameConfig(**{**c["mcfg"], **mcfg_changes}),
            with_stats=True)
    return imgs.numpy(), {k: v.numpy() for k, v in stats.items()}, vis


@pytest.fixture(scope="module")
def runs():
    """Each case's runs, made once on first use: chord_tpu's compile of a
    case serves every test of it."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = dict(jax=_run_jax(case), torch=_run_torch(case))
        return cache[case]
    return get


@pytest.mark.parametrize("case", FILE_CASES)
def test_branch_stats_match_exactly(runs, case):
    r = runs(case)
    j_stats, stats = r["jax"][1], r["torch"][1]
    assert set(stats) == set(j_stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v, j_stats[k], err_msg=k)
    assert int(stats["drawn_tris"].min()) > 100
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        assert int(stats.get(k, np.zeros(1)).max()) == 0, k
    mcfg = CASES[case]["mcfg"]
    assert ("draws_phase1" in stats) == mcfg.get("occlusion", True)
    assert ("active_overflow" in stats) == mcfg.get("object_precull", True)
    if CASES[case]["textured"]:
        assert int(stats["draws_masked"].min()) > 0


@pytest.mark.parametrize("case", FILE_CASES)
def test_branch_visibility_matches_exactly(runs, case):
    r = runs(case)
    j_vis, vis = r["jax"][2], r["torch"][2]
    assert len(vis) == len(j_vis) == CASES[case]["frames"]
    for f, (a, b) in enumerate(zip(vis, j_vis)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {f}")
    assert (vis[-1] != 0).mean() > 0.3


@pytest.mark.parametrize("case", FILE_CASES)
def test_branch_images_match(runs, case):
    r = runs(case)
    j_imgs, imgs = r["jax"][0], r["torch"][0]
    c = CASES[case]
    ph, pw = c["cfg"].get("post_height", H), c["cfg"].get("post_width", W)
    assert imgs.shape == j_imgs.shape == (c["frames"], ph, pw, 3)
    diff = np.abs(imgs.astype(np.int32) - j_imgs.astype(np.int32))
    assert (diff <= 2).mean() >= 0.999, (diff.max(), (diff > 2).mean())
    assert imgs[-1].std() > 5.0


class _Buffers:
    """Seeded stand-ins for a frame's gbuffer and pools (the fields
    debug_visualize reads)."""

    def __init__(self, normal, meshlet_lod):
        self.normal = normal
        self.meshlet_lod = meshlet_lod


DEBUG_MODES = ("meshlet", "lod", "normal", "depth", "disocclusion", "motion",
               "gi", "specular", "shadow", "none")


@pytest.mark.parametrize("mode", DEBUG_MODES)
def test_debug_visualize_matches(mode):
    """Every debug view on one frame's seeded buffers: draw slots up to 300
    of meshlet ids up to 2e5 (the hash's int32 products wrap), LOD levels
    0..9 (the palette clamps), and the extras planes the frame passes."""
    rng = np.random.default_rng(21)
    h, w, n_draws, n_meshlets = 64, 128, 300, 200_000
    slot = rng.integers(-1, n_draws, (h, w)).astype(np.int64)
    tri = rng.integers(0, 128, (h, w)).astype(np.int64)
    vis = np.where(slot >= 0, ((slot + 1) << 7) | tri, 0).astype(np.uint32)
    planes = dict(
        hdr=rng.uniform(0, 4, (h, w, 3)), depth=rng.uniform(0, 0.05, (h, w)),
        normal=rng.normal(0, 1, (h, w, 3)),
        draw_meshlet=rng.integers(0, n_meshlets, n_draws),
        meshlet_lod=rng.integers(0, 10, n_meshlets),
        disocclusion=(rng.uniform(size=(h, w)) > 0.7) * 1.0,
        motion=rng.uniform(0, 1.5, (h, w, 3)),
        gi=rng.uniform(0, 1.5, (h, w, 3)),
        specular=rng.uniform(0, 1.5, (h, w, 3)),
        shadow=rng.uniform(-0.5, 1.5, (h, w)))
    planes = {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
              for k, v in planes.items()}
    extras = ("disocclusion", "motion", "gi", "specular", "shadow")

    def call(fn, conv, vis_):
        p = {k: conv(v) for k, v in planes.items()}
        return fn(mode, p["hdr"], vis_, p["depth"],
                  _Buffers(p["normal"], None), p["draw_meshlet"],
                  _Buffers(None, p["meshlet_lod"]),
                  extras={k: p[k] for k in extras})

    ref = np.asarray(call(jmf.debug_visualize, jnp.asarray,
                          jnp.asarray(vis)))
    got = call(mf.debug_visualize, torch.from_numpy,
               torch.from_numpy(vis.view(np.int32))).numpy()
    assert got.shape == ref.shape == (h, w, 3)
    np.testing.assert_array_equal(got, ref)
    if mode not in ("none", "depth", "disocclusion", "shadow"):
        assert len(np.unique(got.reshape(-1, 3), axis=0)) > 5


def test_check_slice_accepts_the_non_gi_branches():
    """Every non-GI flag of chord_tpu's frame passes the slice check, with
    and without the upscale, and so do the GI branches (DDGI, RTAO, the
    probe march, triangle-exact BVH leaves) and the pipelined shadow
    split."""
    from chord_tpu_torch.ops.gi import GIConfig
    from chord_tpu_torch.ops.screen_probe import ScreenProbeConfig
    from chord_tpu_torch.ops.shadow import ShadowConfig

    for post in (dict(post_width=PW, post_height=PH), {}):
        for cfg in [dict(tsr_mode=m) for m in ("gather", "global", "tile")] + [
                dict(enable_tsr=False), dict(output="hdr10")]:
            rcfg = RendererConfig(width=W, height=H, **post, **cfg)
            for mcfg in [dict(occlusion=False), dict(object_precull=False),
                         dict(masked_layers=2, alpha_masked=True,
                              textured=True)] + [
                    dict(debug_mode=m) for m in DEBUG_MODES]:
                mf.check_slice(rcfg, MeshletFrameConfig(**mcfg))
    rcfg = RendererConfig(width=W, height=H)
    for mode in [dict(gi=True, gi_mode="ddgi"),
                 dict(gi=True, gi_cfg=GIConfig(ao_mode="rtao")),
                 dict(gi=True, probe_cfg=ScreenProbeConfig(
                     trace_mode="march")),
                 dict(gi=True, gi_rt=True, rt_granularity="triangle")]:
        mf.check_slice(rcfg, MeshletFrameConfig(**mode))
    mf.check_slice(rcfg, MeshletFrameConfig(
        shadows=True, shadow_cfg=ShadowConfig(pipelined=True)))
