"""chord_tpu's bench-size frames, rendered on the CPU: the port's goldens.

    JAX_PLATFORMS=cpu python tests/bench_goldens.py off        # ~20 min
    JAX_PLATFORMS=cpu python tests/bench_goldens.py nanite     # ~4 min
    JAX_PLATFORMS=cpu python tests/bench_goldens.py interior   # ~14 min
    JAX_PLATFORMS=cpu python tests/bench_goldens.py geo_tex    # ~15 min
    JAX_PLATFORMS=cpu python tests/bench_goldens.py geo_shadow_atmo  # ~18
    JAX_PLATFORMS=cpu python tests/bench_goldens.py all        # ~19 min
    JAX_PLATFORMS=cpu python tests/bench_goldens.py flat       # BASELINE #1
    JAX_PLATFORMS=cpu python tests/bench_goldens.py all_ddgi
    JAX_PLATFORMS=cpu python tests/bench_goldens.py geo_tex_native
    JAX_PLATFORMS=cpu python tests/bench_goldens.py geo_shadow_atmo_split
    JAX_PLATFORMS=cpu python tests/bench_goldens.py off_no_occlusion
    JAX_PLATFORMS=cpu python tests/bench_goldens.py all_4k     # BASELINE #5
    JAX_PLATFORMS=cpu python tests/bench_goldens.py all_cache
    JAX_PLATFORMS=cpu python tests/bench_goldens.py geo_tex_bricks
    JAX_PLATFORMS=cpu python tests/bench_goldens.py all_no_rt
    JAX_PLATFORMS=cpu python tests/bench_goldens.py sharded_all
    JAX_PLATFORMS=cpu python tests/bench_goldens.py sharded_flat
    ... nanite --fma --out DIR    # XLA's default (FMA) build, into DIR
    ... sharded_all --out DIR --keep 0,1,2,3,4,5,6,7   # every frame's PNG
    JAX_PLATFORMS=cpu python tests/bench_goldens.py all_exact_rays
        # after `python tests/bench_parity.py rays all_exact`

The first six cells and `all_4k` are each one bench.py command (CELLS),
rendered by chord_tpu with bench.py's own scene and camera path
(imported: bench.py:64-131) and its config, BVH and LUTs (copied from
bench.py:171-256, adding only interpret=True, without which row_gather
raises on the CPU). The others are chip_smoke.py's frame paths of the
same name, each a bench rung with what chip_smoke.configs changes
(cell_configs): `flat` is BASELINE #1, build_sponza_like(detail=4)'s flat
pools through DeferredRenderer at 1920x1080 along bench.py's Sponza path
(bench.py:127-129), each frame's instances rebased to its camera;
`all_ddgi` is `all` with DDGI over a meshlet BVH built from the path's
instance table; `geo_tex_native` renders geo_tex at 1920x1080 with gather
TSR and the masked depth peel; `geo_shadow_atmo_split` runs the shadow
rung with ShadowConfig(pipelined=True) as bench.py:272-281 runs such a
config (render_sequence_split's frame, then shadow_service_step);
`off_no_occlusion` is `off` with one cull, global TSR and HDR10 output;
`all_cache` is `all` in gi_mode "cache",
`all_no_rt` `all` without BVH rays, `geo_tex_bricks` `geo_tex` under
the r.raster.bricks cvar (set around every frame call: chord_tpu reads
it when the frame is traced). `sharded_all` and `sharded_flat` are
chord_tpu's ShardedRenderer stepping `all` (natively at 1920x1080) and
`flat` frame by frame in two strips, over a mesh of two XLA host
devices (main adds --xla_force_host_platform_device_count=2 to
XLA_FLAGS before JAX starts; the cell refuses to run otherwise), with
the history ShardedRenderer builds itself. The histories are built as
chord_tpu's MeshletRenderer builds them (cell_history: screen probes in
probe mode only).
The ray cell `all_exact_rays` holds no frame: `tests/bench_parity.py rays
all_exact` records the rays of each rt.trace call of the port's CPU frame 0
of chip_smoke's `all_exact` path (a seeded 4,096 of each call) and, for
RTAO's and the specular GI's calls, what their directions are made of,
into tests/goldens/bench/all_exact_rays.npz; trace_rays makes those
directions with chord_tpu's own gi.rtao and the frame's GGX reflection
(ggx_sample_normal), jitted without FMA, from the recorded inputs,
replaces the recorded ones with them, traces every call through
chord_tpu's own triangle BVH of the bench scene (a ray's scan result
depends only on the ray and the step budget) and writes t, leaf and the
BVH arrays' hashes beside them, and the manifest's `rays` entry.
The frames are stepped one by one with their history (the meshlet frame
through render_frame_meshlet), so a run can stop early: after each frame
the kept images are written to tests/goldens/bench/<cell>_f<NN>.png and
the cell's entry of manifest.json (scene, flags, sizes, capacities,
configs, the history's leaf shapes, the per-frame stats and seconds; on
a strip cell the strip count and strip config) is rewritten, with the
sha256 of chord_tpu/'s sources.
The cells run in separate processes at once; the manifest is updated
under a file lock.

chord_tpu is compiled for the CPU without fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2, set by main before JAX starts): the
port rounds every f32 operation (its kernels build with -fmad=false),
while XLA's default CPU build contracts a*b+c. At bench size that
contraction flips the setup tests of near-degenerate triangles (|det|
below f32 resolution; with the flag, chord_tpu's mesh-shader output on
the port's inputs is bit-equal to the port's), which changes drawn_tris
and the draw counts and moves single highlights of the Nanite field.

This module imports jax and chord_tpu: the port and chip_smoke.py never
import it (chip_smoke.py reads only the PNGs and the manifest).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "tests", "goldens", "bench")
MANIFEST = os.path.join(OUT_DIR, "manifest.json")

WIDTH, HEIGHT = 1920, 1080
DETAIL = 3
TARGET_TRIS = 2_600_000
RENDER_SCALE = 0.6667
PATH_FRAMES = 16          # bench.py's default --frames: the camera path
NO_FMA = "--xla_cpu_max_isa=SSE4_2"   # XLA's CPU build without FMA
# cell -> the bench.py command (or chip_smoke.py path) it equals, the
# frames rendered (a prefix of the 16-frame path) and the frames kept as
# PNGs; `rung` is the bench rung a chip_smoke path changes (cell_configs)
CELLS = {
    "off": dict(scene="bistro", features="off", frames=16, keep=(0, 7, 15),
                command="bench.py --features off"),
    "nanite": dict(scene="nanite", features="off", frames=8, keep=(0, 7),
                   command="bench.py --scene nanite --features off"),
    "interior": dict(scene="interior", features="all", frames=8,
                     keep=(0, 7), command="bench.py --scene interior"),
    "geo_tex": dict(scene="bistro", features="geo_tex", frames=8,
                    keep=(0, 7), command="bench.py --features geo_tex"),
    "geo_shadow_atmo": dict(scene="bistro", features="geo_shadow_atmo",
                            frames=8, keep=(0, 7),
                            command="bench.py --features geo_shadow_atmo"),
    "all": dict(scene="bistro", features="all", frames=8, keep=(0, 7),
                command="bench.py"),
    "flat": dict(scene="sponza", features=None, frames=16, keep=(0, 7, 15),
                 command="chip_smoke.py path flat (BASELINE #1)"),
    "all_ddgi": dict(scene="bistro", features="all", frames=8, keep=(0, 7),
                     command="chip_smoke.py path all_ddgi"),
    "geo_tex_native": dict(scene="bistro", features="geo_tex", frames=8,
                           keep=(0, 7),
                           command="chip_smoke.py path geo_tex_native"),
    "geo_shadow_atmo_split": dict(
        scene="bistro", features="geo_shadow_atmo", frames=8, keep=(0, 7),
        command="chip_smoke.py path geo_shadow_atmo_split (bench.py:"
                "272-281's runner for a pipelined-shadow config)"),
    "off_no_occlusion": dict(scene="bistro", features="off", frames=8,
                             keep=(0, 7),
                             command="chip_smoke.py path off_no_occlusion"),
    "all_4k": dict(scene="bistro", features="all", frames=8, keep=(7,),
                   width=3840, height=2160,
                   command="bench.py --width 3840 --height 2160"),
    "all_cache": dict(scene="bistro", features="all", frames=8, keep=(0, 7),
                      command="chip_smoke.py path all_cache (the viewer's "
                              "--gi --gi-mode cache --gi-rt)"),
    "geo_tex_bricks": dict(scene="bistro", features="geo_tex", frames=8,
                           keep=(0, 7),
                           cvars={"r.raster.bricks": True},
                           command="chip_smoke.py path geo_tex_bricks"),
    "all_no_rt": dict(scene="bistro", features="all", frames=8, keep=(0, 7),
                      command="chip_smoke.py path all_no_rt"),
    "sharded_all": dict(
        scene="bistro", features="all", frames=8, keep=(0, 7), strips=2,
        command="chip_smoke.py path sharded_all (chord_tpu.parallel.sharded"
                ".ShardedRenderer, path='meshlet', two host devices)"),
    "sharded_flat": dict(
        scene="sponza", features=None, frames=8, keep=(0, 7), strips=2,
        command="chip_smoke.py path sharded_flat (chord_tpu.parallel."
                "sharded.ShardedRenderer, path='flat', two host devices)"),
}
# ray cells (chip_smoke.GOLDEN_RAYS): the rays of each rt.trace call of a
# chip_smoke path's frame 0, recorded from the port's CPU frame by
# `tests/bench_parity.py rays PATH` (a seeded subset of each call), traced
# here through chord_tpu's own BVH of the path's scene
RAY_CELLS = {
    "all_exact_rays": dict(
        path="all_exact", scene="bistro", rung="all",
        granularity="triangle", gi_cfg=dict(ao_mode="rtao"),
        command="chip_smoke.py path all_exact (frame 0's rt.trace calls: "
                "RTAO's four, the probe rays, SSR's misses)"),
}
# BASELINE #1 as chip_smoke.py's flat path renders it
FLAT_DETAIL = 4
FLAT_PAIRS = 16384
# the strip cells' XLA host devices (one a strip), set before JAX starts
STRIP_DEVICES = "--xla_force_host_platform_device_count={}"


def _bench():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench
    return bench


def bench_configs(features: str, width: int = WIDTH, height: int = HEIGHT,
                  blend_textured: bool = False,
                  render_scale: float = RENDER_SCALE,
                  draw_capacity: int = 2048):
    """bench.py's RendererConfig and MeshletFrameConfig for a rung at
    width x height (bench.py:171-219), with interpret=True."""
    from chord_tpu.ops.screen_probe import ScreenProbeConfig
    from chord_tpu.renderer.deferred import RendererConfig
    from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig

    bench = _bench()
    rw = int(width * render_scale) // 8 * 8
    rh = int(height * render_scale) // 8 * 8
    if rw > 1280:
        draw_capacity = max(draw_capacity, 4096)
    config = RendererConfig(width=rw, height=rh,
                            post_width=width if render_scale != 1.0 else 0,
                            post_height=height if render_scale != 1.0 else 0,
                            pair_capacity=8192 if rw <= 1280 else 24576,
                            big_capacity=64 if rw <= 1280 else 128,
                            enable_bloom=True, enable_tsr=True,
                            tsr_mode="tile", interpret=True)
    lvl = bench.FEATURE_LEVELS[features]
    mcfg = MeshletFrameConfig(
        draw_capacity=draw_capacity, masked_draw_capacity=256,
        occlusion=True,
        shadows=lvl["shadows"], atmosphere=lvl["atmosphere"],
        gi=lvl["gi"], gi_mode="probe", gi_rt=lvl["gi"], rt_rays=2,
        ssr=lvl["gi"],
        textured=lvl["textured"], alpha_masked=lvl["textured"],
        alpha_blend=lvl["textured"],
        blend_textured=blend_textured,
        normal_mapped=lvl["pbr"], pbr_textures=lvl["pbr"],
        shadow_masked=lvl["shadow_masked"],
        trilinear=lvl["trilinear"],
        probe_cfg=ScreenProbeConfig(rays=16, steps=6,
                                    history_mode="tile"))
    return config, mcfg


def cell_configs(cell: str, blend_textured: bool = False):
    """The cell's RendererConfig and MeshletFrameConfig (interpret=True):
    bench.py's for its rung, with what chip_smoke.configs changes on a
    chip_smoke path; on `flat` the flat frame's config and None."""
    from chord_tpu.renderer.deferred import RendererConfig

    spec = CELLS[cell]
    if spec["scene"] == "sponza":
        return RendererConfig(width=WIDTH, height=HEIGHT,
                              pair_capacity=FLAT_PAIRS, big_capacity=128,
                              subtiles=True, enable_bloom=True,
                              enable_tsr=True, interpret=True), None
    config, mcfg = bench_configs(spec["features"],
                                 spec.get("width", WIDTH),
                                 spec.get("height", HEIGHT),
                                 blend_textured=blend_textured)
    if "strips" in spec:
        # rendered natively: the strips' history has no post size
        config = config._replace(width=WIDTH, height=HEIGHT, post_width=0,
                                 post_height=0)
    if cell == "all_ddgi":
        from chord_tpu.ops.ddgi import DDGIConfig
        mcfg = mcfg._replace(gi_mode="ddgi", ddgi_cfg=DDGIConfig(),
                             rt_granularity="meshlet")
    elif cell == "geo_tex_native":
        config = config._replace(width=WIDTH, height=HEIGHT, post_width=0,
                                 post_height=0, tsr_mode="gather")
        mcfg = mcfg._replace(masked_layers=2)
    elif cell == "geo_shadow_atmo_split":
        mcfg = mcfg._replace(
            shadow_cfg=mcfg.shadow_cfg._replace(pipelined=True))
    elif cell == "off_no_occlusion":
        config = config._replace(tsr_mode="global", output="hdr10")
        mcfg = mcfg._replace(occlusion=False, object_precull=False)
    elif cell == "all_cache":
        mcfg = mcfg._replace(gi_mode="cache")
    elif cell == "all_no_rt":
        mcfg = mcfg._replace(gi_rt=False)
    return config, mcfg


def flat_frames(b, w: int = WIDTH, h: int = HEIGHT,
                frames: int = PATH_FRAMES):
    """bench.py's Sponza camera path (bench.py:127-129), without jitter:
    each frame's view uniform and instance table, rebased to that frame's
    camera -> ([uniforms], [instances])."""
    from chord_tpu.utils.camera import Camera

    cam = Camera(width=w, height=h)
    uniforms, insts = [], []
    for i in range(frames):
        t = i / max(frames - 1, 1)
        cam.position = np.array([-16.0 + 6.0 * t, 4.5, 3.0])
        cam.look_at(np.array([12.0, 2.0, -2.0]))
        uniforms.append(cam.view_uniform(i))
        insts.append(b.frame_instances(cam))
    return uniforms, insts


def camera_uniforms(scene: str, w: int, h: int, cam=None):
    """bench.py's 16 view uniforms of `scene` at w x h (bench.py:112-131);
    `cam` ends at the path's last position."""
    from chord_tpu.utils.camera import Camera

    cam = cam or Camera(width=w, height=h)
    return _bench()._camera_path(scene, cam, PATH_FRAMES)


def _luts(dviews):
    """The views with the LUTs of _lut_arrays."""
    luts = _lut_arrays()
    return [v.replace(**luts) for v in dviews]


def _lut_arrays() -> dict:
    """The sun-independent LUTs, built once (bench.py:236-256), by
    DeviceView field."""
    import jax

    from chord_tpu.ops import atmosphere as atm
    from chord_tpu.ops import brdf_lut as brdf

    p_atm = atm.AtmosphereParams()
    t_lut = jax.jit(atm.build_transmittance_lut,
                    static_argnums=1)(p_atm, 40)
    ms_lut = jax.jit(lambda tl: atm.build_multiscatter_lut(
        p_atm, tl, dir_samples=16, steps=12))(t_lut)
    lut = jax.jit(brdf.build_env_brdf_lut, static_argnums=0)(64)
    sun_d = np.asarray([0.3, 0.8, 0.5], np.float32)
    sun_d /= np.linalg.norm(sun_d)
    sky_lut = jax.jit(lambda tl, msl: atm.build_sky_view_lut(
        p_atm, tl, msl, jax.numpy.asarray(sun_d)))(t_lut, ms_lut)
    return dict(atmo_t_lut=t_lut, atmo_ms_lut=ms_lut, atmo_sky_lut=sky_lut,
                brdf_lut=lut)


def _write_png(path: str, img) -> None:
    from PIL import Image

    Image.fromarray(img).save(path + ".tmp", format="PNG", optimize=True)
    os.replace(path + ".tmp", path)


def _update_manifest(out_dir: str, cell: str, entry: dict,
                     section: str = "cells") -> None:
    import fcntl

    from chip_smoke import chord_tpu_hash

    path = os.path.join(out_dir, "manifest.json")
    lock = os.open(out_dir, os.O_RDONLY)     # the directory is the lock
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        man = {}
        if os.path.exists(path):
            with open(path) as f:
                man = json.load(f)
        man["chord_tpu_sha256"] = chord_tpu_hash(REPO)
        man.setdefault(section, {})[cell] = entry
        with open(path + ".tmp", "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(path + ".tmp", path)
    finally:
        os.close(lock)


def _setup_flat(cell: str) -> dict:
    """BASELINE #1: chord_tpu's Sponza at FLAT_DETAIL, its flat pools and
    the path's uniforms and instances; `step` renders a frame through
    DeferredRenderer.render."""
    from chord_tpu.asset.procedural import build_sponza_like
    from chord_tpu.renderer.deferred import DeferredRenderer
    from chord_tpu.rhi.framebuffer import FrameHistory

    b = build_sponza_like(detail=FLAT_DETAIL)
    pools = b.build_pools()
    config, _ = cell_configs(cell)
    uniforms, insts = flat_frames(b)
    n_src = sum(b.meshes[m].num_triangles for m, _, _ in b.instances)
    c = dict(pools=pools, inst=insts, views=uniforms, config=config,
             mcfg=None, bvh=None, lvl=None, scene="sponza", features=None,
             n_src=n_src)
    if "strips" in CELLS[cell]:
        return dict(c, **_strip_step(cell, config, None, pools, insts,
                                     uniforms))
    r = DeferredRenderer(config)

    def step(i, hist):
        r.history = hist
        img, stats = r.render(pools, insts[i], uniforms[i])
        return img, r.history, stats

    return dict(c, step=step,
                hist=FrameHistory.empty(config.height, config.width))


def _strip_step(cell: str, config, mcfg, pools, insts, uniforms, bvh=None,
                luts=None, **light_kwargs) -> dict:
    """A strip cell: chord_tpu's ShardedRenderer over a mesh of the
    cell's XLA host devices (sharded.py:89-181), `step(i, hist)` its
    render of frame i (the history as it builds it: hist None) ->
    {step, hist, strip_config}."""
    import jax
    from jax.sharding import Mesh

    from chord_tpu.parallel.sharded import AXIS, ShardedRenderer

    n = CELLS[cell]["strips"]
    if (STRIP_DEVICES.format(n) not in os.environ.get("XLA_FLAGS", "")
            or jax.device_count() != n):
        raise RuntimeError(f"{cell}: XLA_FLAGS must hold "
                           f"{STRIP_DEVICES.format(n)} before JAX starts "
                           f"(run this module as a script); JAX has "
                           f"{jax.device_count()} devices")
    r = ShardedRenderer(config, Mesh(np.array(jax.devices()), (AXIS,)),
                        path="flat" if mcfg is None else "meshlet",
                        mcfg=mcfg)

    def step(i, hist):
        r.history = hist
        img, stats = r.render(pools, insts[i], uniforms[i], bvh=bvh,
                              luts=luts, **light_kwargs)
        return img, r.history, stats

    return dict(step=step, hist=None, strip_config=r.strip_config)


def cell_history(cell: str, config, mcfg):
    """chord_tpu's fresh history of a one-card cell (None on a strip
    cell: ShardedRenderer builds its own), for bench.py's frame as
    MeshletRenderer.render builds it (meshlet_frame.py:1540-1560): screen
    probes in probe mode only, DDGI's state in ddgi mode."""
    from chord_tpu.ops.gi import GIConfig
    from chord_tpu.rhi.framebuffer import FrameHistory

    if "strips" in CELLS[cell]:
        return None
    if mcfg is None:
        return FrameHistory.empty(config.height, config.width)
    ddgi = mcfg.gi and mcfg.gi_mode == "ddgi"
    return FrameHistory.empty(
        config.height, config.width, post_h=config.post_height or None,
        post_w=config.post_width or None,
        gi_cfg=GIConfig() if mcfg.gi else None,
        shadow_cascades=(mcfg.shadow_cfg.cascade_count
                         if mcfg.shadows else 0),
        shadow_res=(mcfg.shadow_cfg.resolution if mcfg.shadows else 1),
        shadow_div=mcfg.shadow_cfg.eval_res_div,
        shadow_phase=(mcfg.shadow_cfg.temporal_phase
                      if mcfg.shadow_cfg.temporal else 1),
        probe_tile=8 if mcfg.gi and mcfg.gi_mode == "probe" else 0,
        ddgi_cfg=mcfg.ddgi_cfg if ddgi else None)


def history_shapes(hist, strips: int = 0) -> dict:
    """{leaf: shape} of a chord_tpu history (chip_smoke's leaf names); a
    strip history without its leading (strips,) axis."""
    from chip_smoke import history_leaves

    return {k: list(np.shape(v))[1 if strips else 0:]
            for k, v in sorted(history_leaves(hist).items())}


def setup_cell(cell: str, fma: bool = False) -> dict:
    """chord_tpu's scene, configs, BVH, views and fresh history of `cell`,
    as bench.py builds them (interpret=True), and `step(i, hist)` ->
    (image, history, stats), its jitted frame i (on the split the frame,
    then its shadow service)."""
    import jax

    from chord_tpu.renderer.deferred import DeviceView
    from chord_tpu.renderer.meshlet_frame import (_split_sequence_fns,
                                                  render_frame_meshlet,
                                                  shadow_pipelined)
    from chord_tpu.utils.camera import Camera
    from chord_tpu.utils.cvar import cvars

    if (NO_FMA in os.environ.get("XLA_FLAGS", "")) == fma:
        raise RuntimeError(f"XLA_FLAGS must {'not ' if fma else ''}hold "
                           f"{NO_FMA} before JAX starts (run this module "
                           "as a script)")
    spec = CELLS[cell]
    if spec["scene"] == "sponza":
        return _setup_flat(cell)
    bench = _bench()
    scene, features = spec["scene"], spec["features"]
    b, pools, n_src = bench._make_scene(scene, DETAIL, TARGET_TRIS)
    blend_tex = any(m.alpha_mode == "blend" and m.base_color_texture >= 0
                    for m in b.materials)
    config, mcfg = cell_configs(cell, blend_tex)
    lvl = bench.FEATURE_LEVELS[features]
    rw, rh = config.width, config.height
    cam = Camera(width=rw, height=rh)
    bvh = None
    if mcfg.gi_rt and mcfg.gi_mode != "ddgi":
        from chord_tpu.ops.rt import build_scene_bvh
        bvh = build_scene_bvh(pools, b.frame_instances(cam),
                              granularity="object")
    views_u = camera_uniforms(scene, rw, rh, cam)
    shadow_cfg = mcfg.shadow_cfg if lvl["shadows"] else None
    dviews = [DeviceView.from_uniform(u, shadow_cfg=shadow_cfg)
              for u in views_u]
    if (lvl["atmosphere"] or lvl["gi"] or lvl["shadows"]) and \
            "strips" not in spec:
        dviews = _luts(dviews)
    ddgi = mcfg.gi and mcfg.gi_mode == "ddgi"
    hist = cell_history(cell, config, mcfg)
    inst = b.frame_instances(cam)
    c = dict(pools=pools, inst=inst, views=dviews, config=config, mcfg=mcfg,
             bvh=bvh, lvl=lvl, scene=scene, features=features, n_src=n_src)
    if "strips" in spec:
        return dict(c, **_strip_step(
            cell, config, mcfg, pools, [inst] * len(views_u), views_u,
            bvh=bvh, luts=_lut_arrays(),
            shadow_cfg=mcfg.shadow_cfg if mcfg.shadows else None))
    if ddgi:
        # as MeshletRenderer builds it: from the frames' own instance
        # table (the camera at the path's last position)
        from chord_tpu.ops.rt import build_scene_bvh
        bvh = build_scene_bvh(pools, inst,
                              granularity=mcfg.rt_granularity)
    if lvl["shadows"] and shadow_pipelined(mcfg.shadow_cfg):
        frame_fn, svc_fn = _split_sequence_fns(config, mcfg)

        def step(i, h):      # render_sequence_split's loop body
            img, h, stats = frame_fn(pools, inst, dviews[i], h, bvh)
            sp = stats.get("shadow_split")
            if sp is not None:
                maps, mats, _, mask = svc_fn(pools, inst, dviews[i], h, sp)
                h = h.replace(shadow_maps=maps, shadow_mats=mats,
                              shadow_mask=mask)
            return img, h, stats
    else:
        fn = jax.jit(functools.partial(render_frame_meshlet, config=config,
                                       mcfg=mcfg, bvh=bvh))
        bricks = spec.get("cvars", {}).get("r.raster.bricks", False)

        def step(i, h):
            # chord_tpu reads r.raster.bricks when a frame is traced
            # (deferred.py:172): every call that may compile runs under it
            was = cvars.get("r.raster.bricks")
            cvars.set("r.raster.bricks", bricks)
            try:
                return fn(pools, inst, dviews[i], h)
            finally:
                cvars.set("r.raster.bricks", was)
    return dict(c, step=step, hist=hist)


def render_cell(cell: str, frames: int | None = None,
                out_dir: str = OUT_DIR, fma: bool = False,
                keep=None) -> None:
    """Render frames 0..frames-1 of `cell` (default: CELLS') frame by
    frame, writing the kept PNGs (default: CELLS') and the manifest entry
    into `out_dir` after each; `fma`: XLA's default CPU build (for
    comparison only)."""
    from chip_smoke import config_dict

    spec = CELLS[cell]
    frames = frames or spec["frames"]
    keep = spec["keep"] if keep is None else keep
    t0 = time.time()
    c = setup_cell(cell, fma)
    config, mcfg, hist = c["config"], c["mcfg"], c["hist"]
    out_hw = (config.post_height or config.height,
              config.post_width or config.width)
    print(f"{cell}: scene {c['scene']} ({c['n_src']} source tris) and "
          f"views in {time.time() - t0:.1f} s", flush=True)
    strips = spec.get("strips", 0)
    flags = ([] if fma else [NO_FMA]) + (
        [STRIP_DEVICES.format(strips)] if strips else [])
    entry = dict(
        command=spec["command"], xla_flags=" ".join(flags),
        scene=c["scene"],
        detail=FLAT_DETAIL if c["scene"] == "sponza" else DETAIL,
        target_tris=TARGET_TRIS if c["scene"] == "bistro" else None,
        source_tris=int(c["n_src"]), features=c["features"],
        flags=c["lvl"], width=out_hw[1], height=out_hw[0],
        render_width=config.width, render_height=config.height,
        render_scale=RENDER_SCALE if config.post_width else 1.0,
        path_frames=PATH_FRAMES,
        draw_capacity=mcfg.draw_capacity if mcfg else None,
        masked_draw_capacity=mcfg.masked_draw_capacity if mcfg else None,
        pair_capacity=config.pair_capacity,
        big_capacity=config.big_capacity,
        renderer_config=config_dict(config),
        meshlet_config=config_dict(mcfg) if mcfg else None,
        frames_rendered=0, images={}, stats=[], seconds=[])
    if "cvars" in spec:
        entry["cvars"] = spec["cvars"]
    if strips:
        entry.update(strips=strips,
                     strip_config=config_dict(c["strip_config"]))
    for i in range(frames):
        t1 = time.time()
        img, hist, stats = c["step"](i, hist)
        img = np.asarray(img)
        dt = time.time() - t1
        if img.shape != out_hw + (3,) or img.dtype != np.uint8:
            raise RuntimeError(f"{cell} frame {i}: image {img.shape} "
                               f"{img.dtype}")
        st = {k: int(np.asarray(v)) for k, v in stats.items()
              if not isinstance(v, dict) and np.ndim(v) == 0 and
              np.issubdtype(np.asarray(v).dtype, np.integer)}
        entry["history"] = history_shapes(hist, strips)
        entry["stats"].append(st)
        entry["seconds"].append(round(dt, 3))
        entry["frames_rendered"] = i + 1
        if i in keep:
            name = f"{cell}_f{i:02d}.png"
            _write_png(os.path.join(out_dir, name), img)
            entry["images"][str(i)] = name
        _update_manifest(out_dir, cell, entry)
        print(f"{cell} frame {i}: {dt:.1f} s, stats {st}", flush=True)


# the recorded arrays of a ray cell (tests/bench_parity.py `rays`)
RAY_INPUTS = ("calls", "origins", "dirs", "t_max", "seed", "call_rays",
              "pixel", "plane", "pos", "normal", "rough", "frame_count")


def _plane(data, key: str, k: int):
    """The recorded values of call k at its kept pixels, scattered into
    the call's plane (zero elsewhere)."""
    h, w = (int(v) for v in data["plane"][k])
    c = 1 if data[key].ndim == 2 else 3
    x = np.zeros((h * w, c), np.float32)
    x[data["pixel"][k]] = data[key][k].reshape(-1, c)
    return x.reshape(h, w, c) if c > 1 else x.reshape(h, w)


def jax_specular_directions(pos_q, nrm_q, rough_q, frame_count):
    """chord_tpu's specular GI directions (renderer/meshlet_frame.py:
    969-984): the view -pos / |pos|, the IGN pair of `frame_count`,
    ggx_sample_normal and the view reflected about it -> refl_q."""
    import jax.numpy as jnp

    from chord_tpu.ops import bluenoise as jbn
    from chord_tpu.ops import screen_probe as jsp

    v_q = -pos_q / jnp.maximum(
        jnp.linalg.norm(pos_q, axis=-1, keepdims=True), 1e-6)
    hq, wq = rough_q.shape
    u1 = jbn.interleaved_gradient_noise(hq, wq, frame_count)
    u2 = jbn.interleaved_gradient_noise(hq, wq, frame_count + 31)
    h_ggx = jsp.ggx_sample_normal(nrm_q, v_q, rough_q, u1, u2)
    return 2.0 * jnp.sum(v_q * h_ggx, -1, keepdims=True) * h_ggx - v_q


def golden_directions(data, gi_cfg) -> dict:
    """chord_tpu's directions of the kept rays of each call whose inputs a
    ray cell recorded, from those inputs at the frame's plane size: RTAO's
    k-th fan ray (gi.rtao with `gi_cfg`, its trace stubbed) and the
    specular GI's reflection (jax_specular_directions), each jitted ->
    {call index: (N,3)}."""
    import jax
    import jax.numpy as jnp

    from chord_tpu.ops import gi as jgi
    from chord_tpu.ops import rt as jrt

    def rtao_dirs(pos, nrm, fc):
        seen = []
        trace = jrt.trace

        def stub(o, d, bvh, t_max=1e9, max_steps=None):
            seen.append(d)
            shape = o.shape[:-1]
            return jnp.full(shape, t_max, jnp.float32), jnp.full(
                shape, -1, jnp.int32)
        jrt.trace = stub
        try:
            jgi.rtao(pos, nrm, None, gi_cfg, frame_index=fc)
        finally:
            jrt.trace = trace
        return seen

    fc = jnp.int32(int(data["frame_count"]))
    out = {}
    for k, name in enumerate(data["calls"].tolist()):
        if int(data["plane"][k][0]) <= 0:
            continue
        pos, nrm = _plane(data, "pos", k), _plane(data, "normal", k)
        if name == "specular":
            d = jax.jit(jax_specular_directions)(pos, nrm,
                                                 _plane(data, "rough", k), fc)
        else:
            d = jax.jit(rtao_dirs)(pos, nrm, fc)[int(name[len("rtao"):])]
        out[k] = np.asarray(d).reshape(-1, 3)[data["pixel"][k]]
    return out


def trace_rays(cell: str, out_dir: str = OUT_DIR) -> None:
    """A ray cell: the rays `tests/bench_parity.py rays` recorded into
    OUT_DIR/<cell>.npz, RTAO's and the specular GI's directions made anew
    by chord_tpu from the recorded inputs (golden_directions, replacing
    the recorded ones; how many of the port's CPU frame's differed is
    printed and kept in the manifest), traced by chord_tpu's jitted
    rt.trace (the BVH scan at its default budget, each call's t_max) over
    chord_tpu's own BVH of the cell's scene, built as chip_smoke.path_bvh
    builds the port's: bench.py's bistro, the path's instance table (the
    camera at the camera path's last position), the cell's granularity,
    the native builder. Writes the directions, t and leaf and the BVH's
    hashes (chip_smoke.bvh_hashes) into the npz, and the cell's entry into
    the manifest's `rays`."""
    import jax

    from chip_smoke import bvh_hashes
    from chord_tpu.native import available
    from chord_tpu.ops import rt as jrt
    from chord_tpu.ops.gi import GIConfig
    from chord_tpu.utils.camera import Camera

    if NO_FMA not in os.environ.get("XLA_FLAGS", ""):
        raise RuntimeError(f"XLA_FLAGS must hold {NO_FMA} before JAX starts "
                           "(run this module as a script)")
    if not available():
        raise RuntimeError("the native BVH builder did not load")
    spec = RAY_CELLS[cell]
    path = os.path.join(out_dir, f"{cell}.npz")
    with np.load(path) as f:
        data = {k: f[k] for k in RAY_INPUTS}
    t0 = time.time()
    golden = golden_directions(data, GIConfig(**spec["gi_cfg"]))
    port_differ = {}
    for k, d in golden.items():
        name = data["calls"][k]
        port_differ[str(name)] = int((d.view(np.int32) != data["dirs"][k].view(
            np.int32)).any(-1).sum())
        data["dirs"][k] = d
        print(f"{cell} call {name}: chord_tpu's directions from the "
              f"recorded inputs; the port's CPU frame's differ on "
              f"{port_differ[str(name)]} of {d.shape[0]}", flush=True)
    dir_s = time.time() - t0
    t0 = time.time()
    b, pools, n_src = _bench()._make_scene(spec["scene"], DETAIL,
                                           TARGET_TRIS)
    config, _ = cell_configs(spec["rung"])
    cam = Camera(width=config.width, height=config.height)
    camera_uniforms(spec["scene"], config.width, config.height, cam)
    bvh = jrt.build_scene_bvh(pools, b.frame_instances(cam),
                              granularity=spec["granularity"])
    hashes = bvh_hashes(bvh)
    setup_s = time.time() - t0
    print(f"{cell}: scene ({n_src} source tris) and the "
          f"{spec['granularity']} BVH ({bvh.node_sphere.shape[0]} nodes, "
          f"{bvh.leaf_sphere.shape[0]} leaves) in {setup_s:.1f} s",
          flush=True)
    fn = jax.jit(lambda o, d, bv, tm: jrt.trace(o, d, bv, t_max=tm))
    ts, leaves, secs = [], [], []
    for k, name in enumerate(data["calls"].tolist()):
        t1 = time.time()
        t, leaf = fn(data["origins"][k], data["dirs"][k], bvh,
                     np.float32(data["t_max"][k]))
        ts.append(np.asarray(t))
        leaves.append(np.asarray(leaf))
        secs.append(round(time.time() - t1, 3))
        print(f"{cell} call {name}: {ts[-1].size} rays, hit share "
              f"{(leaves[-1] >= 0).mean():.5f}, {secs[-1]} s", flush=True)
    np.savez_compressed(path + ".tmp.npz", **data, t=np.stack(ts),
                        leaf=np.stack(leaves),
                        bvh_sha256=np.array(json.dumps(hashes,
                                                       sort_keys=True)))
    os.replace(path + ".tmp.npz", path)
    _update_manifest(out_dir, cell, dict(
        command=spec["command"], path=spec["path"], file=f"{cell}.npz",
        xla_flags=NO_FMA, scene=spec["scene"], detail=DETAIL,
        target_tris=TARGET_TRIS, source_tris=int(n_src),
        granularity=spec["granularity"],
        render_width=config.width, render_height=config.height,
        max_steps=int(min(bvh.node_sphere.shape[0],
                          1536 if bvh.tri_planes is not None else 384)),
        calls=data["calls"].tolist(), call_rays=data["call_rays"].tolist(),
        rays_per_call=int(data["origins"].shape[1]), seed=int(data["seed"]),
        t_max=data["t_max"].tolist(), bvh=hashes,
        held_directions=sorted(port_differ),
        port_directions_differ=port_differ, gi_cfg=spec["gi_cfg"],
        frame_count=int(data["frame_count"]),
        directions_seconds=round(dir_s, 3),
        hit_share=[float((lf >= 0).mean()) for lf in leaves],
        setup_seconds=round(setup_s, 3), seconds=secs), section="rays")
    print(f"wrote {path} ({os.path.getsize(path)} B) and the manifest's "
          f"rays entry", flush=True)


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell", choices=list(CELLS) + list(RAY_CELLS))
    ap.add_argument("--frames", type=int, help="frames 0..N-1 (default: "
                    "the cell's)")
    ap.add_argument("--out", default=OUT_DIR, help="the directory written "
                    "(default: the goldens)")
    ap.add_argument("--fma", action="store_true", help="XLA's default CPU "
                    "build (needs --out)")
    ap.add_argument("--keep", help="the frames written as PNGs, e.g. "
                    "0,1,7 (default: the cell's; other frames need --out)")
    args = ap.parse_args(argv[1:])
    if os.path.abspath(args.out) == OUT_DIR and (args.fma or args.keep):
        ap.error("--fma and --keep write only with --out")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    if args.cell in RAY_CELLS:
        if args.fma or args.keep or args.frames:
            ap.error("a ray cell takes only --out")
        os.environ["XLA_FLAGS"] = " ".join(
            [os.environ.get("XLA_FLAGS", ""), NO_FMA]).strip()
        trace_rays(args.cell, args.out)
        return 0
    strips = CELLS[args.cell].get("strips")
    flags = ([] if args.fma else [NO_FMA]) + (
        [STRIP_DEVICES.format(strips)] if strips else [])
    os.environ["XLA_FLAGS"] = " ".join(
        [os.environ.get("XLA_FLAGS", "")] + flags).strip()
    os.makedirs(args.out, exist_ok=True)
    render_cell(args.cell, args.frames, args.out, fma=args.fma,
                keep=None if args.keep is None else
                {int(f) for f in args.keep.split(",")})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
