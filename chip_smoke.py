#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (chord_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the default run
    python3 chip_smoke.py --profile    # + a torch.profiler breakdown per path

Eight paths: six frame paths and two tool paths. Three are the bench's
`off`, `geo_tex` and `geo_shadow_atmo` rungs (bench.py:35-54): the
1280x720 render of the 2.6M-triangle procedural bistro (Nanite LOD cut),
upscaled to 1920x1080 by tile-mode TSR, bloom and the ACES tonemap;
`geo_tex` adds the bench texture pool (12 layers of 256², block-compressed
pages), base / normal / metal-rough maps, the alpha-masked bucket and the
blend bucket, on the bistro built with textures=True; `geo_shadow_atmo`
renders the same textured bistro with ShadowConfig() (4 cascades of 1024²,
round-robin refresh, scrolled cache, alpha-tested masked casters, PCSS on
a 2x2 phase of the 1/4-res grid, temporal mask), the physically based sky,
sun tint, ambient and aerial perspective, with the atmosphere LUTs built
once (bench.py:236-256). `geo_tex_bricks` is `geo_tex` with the
r.raster.bricks cvar set for the whole path: the brick raster (K7)
replaces K1 in both occlusion phases and the masked and blend buckets.
`all_no_rt` is the bench's `all` rung (bench.py:35-36, 204-219) with only
gi_rt=False changed: `geo_shadow_atmo`'s scene, views and LUTs plus
screen-probe GI (ScreenProbeConfig(rays=16, steps=6, history_mode="tile"),
GIConfig()), SSAO, the specular chain with SSR, trilinear mip dither and
the env-BRDF LUT built once (bench.py:248); it runs K4 twice a frame (the
TSR history and the half-res GI history). `flat` is the flat
DeferredRenderer frame (BASELINE config #1: object
frustum cull, every triangle of the visible objects, deferred PBR) of
build_sponza_like(detail=4) (367,104 padded triangles) at 1920x1080 along
bench.py's Sponza camera path (bench.py:127-129), with
RendererConfig(subtiles=True): the sub-tile raster (K8) at pair capacity
16384 (the class default 8192 drops pairs on this scene), big capacity
128, bloom and gather-mode TSR. The tool paths are the port's
chord_tpu_torch/tools: `repro_eval` runs all 22 variants of the
shadow-evaluate fault bisection at its bench shapes (`tm_pallas` puts the
fusion barrier K9 between the evaluate and the temporal blend), and
`proto_paged_tex` the paged-texture prototype (palette sampler K10) at its
own size, 1056x1920.

Phases (any failure raises and the script exits non-zero):

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the ten hand-written kernels (chord_tpu_torch/csrc/*.cu, one
   nvcc per source, all at once) into build/kernels/, prints the
   registers, shared memory and spills ptxas reports for K6 and K10, and
   times the launch floor: an empty one-block grid (csrc/launch_floor.cu)
   timed as the kernels are, the least time any launched kernel takes.
3. Builds the scenes (the two bistros share the Nanite DAG of their common
   meshes; the shadow and brick paths reuse the textured one; the flat
   Sponza pools with a per-frame instance table) and the LUTs, and prints
   build time, page count and pool bytes.
4. Kernel vs plain version, per path: renders the path's first frame
   (on the shadow path its first four, so every cascade holds depth),
   then records every kernel call's inputs through the next frame, and
   runs each kernel and its plain PyTorch version on those calls (K1
   raster on the three bench rungs; K2 mesh shader, K3 row gather, K4 tile
   reproject on every meshlet path, both of its calls on `all_no_rt`; K5
   paged texture sampler on the textured paths, with the masked shadow
   casters on the shadow paths; K6 PCSS on `geo_shadow_atmo` and
   `all_no_rt`; K7 brick raster on `geo_tex_bricks`; K8 sub-tile raster
   on `flat`).
   Tolerance 0: the kernels are built with -fmad=false and round every
   operation as the plain versions do. Times each call (CUDA events,
   inputs L2-warm, queued behind a device-side sleep so the events see the
   device's time and not the host's issue rate; the issue-paced time is
   kept beside it), computes its bound (the larger of the bytes it must
   move over 3.35 TB/s and the f32 operations this run's data needs over
   67 TFLOP/s; the bytes are its inputs and outputs, except that K6 counts
   the 32-B sectors of the stack its taps touch, not the whole stack; K1,
   K7 and K8's operations are the pixel tests their exact per-warp corner
   cull leaves on this run's queue x 21 flops plus 12 per cull evaluation
   (raster.cull_tests, K7's in its own association), with the bound of
   every test of the visit list kept beside it as `bound_all_tests_ms`)
   and, for K3 and K9, times one PyTorch call of the same function
   (torch.index_select of the same rows, x.clone()) as a library
   yardstick, kernel and library in turn over 5 rounds of 200 calls
   (medians, with the rounds' spread); K4's two calls of an `all_no_rt`
   frame are timed in turn the same way. For each K1, K7 and K8 call it
   prints a `work` line, off the timed window: per tile the pairs (K1, K7)
   or rounds (K8) and the row visits, per block of the kernels'
   decomposition (32 columns a warp x raster.K1_BAND / K7_BAND / K8_BAND
   rows, raster.band_split) the row visits, and the blocks launched; for
   K6 the in-map pixels, the PCF radius's distribution and the stack
   sectors the taps touch; for K10 the distinct tiles a pixel block asks
   for and the share of textured pixels the palette serves.
5. Each path's 16-frame sequence (render_sequence_meshlet(with_stats=True);
   on `flat`, DeferredRenderer.render frame by frame), with every launch
   count set to 0 just before and read just after: worst-frame overflows
   0, drawn triangles > 0, a finite non-constant image, every kernel of
   the path launched and no other (kernels.EXPECTED_LAUNCHES: K4 16
   times, 32 on `all_no_rt`; K5 32 times on `geo_tex` and
   `geo_tex_bricks`, 40 on the shadow paths: 32 plus the masked casters
   of the 8 frames that refresh cascade 0 or 1; K6 16 times; K7 64 times;
   K8 16 times), masked draws on some frame of the textured paths, a
   finite cascade cache and shadow mask, on `all_no_rt` the GI history
   (chord_tpu's shapes, probes with samples, a world cache that took
   probes, non-negative non-zero diffuse and specular histories) and,
   from a second run, whether images and world cache repeat bit for bit;
   and per cascade the shadow draws
   (read from the K2 calls) beside what the cull asked for and the pairs
   the bins dropped (none allowed); then the sequence three more times for
   ms/frame (median and spread). At bench.py's shadow_draw_capacity=2048
   the far cascade asks for more draws than that and drops the rest, as
   chord_tpu does at this config: printed, not failed. The shadow path
   then runs once more at 4096, where every cascade must stay below its
   capacity, and is timed there too. With --profile, each path's device
   busy share and ops per frame, and on `all_no_rt` each GI stage's
   device and host ms (its record_function span).
6. `repro_eval`: every variant through the tool's run_variant (one call
   at frame 1, three steady), launch counts set to 0 before each variant
   and read after it (K9 1 + 3 times on `tm_pallas`, no kernel on any
   other), the first call's outputs against the same variant on the CPU,
   each variant's steady ms; K9 against its plain version on
   `tm_pallas`'s first call (tolerance 0), timed in turn with x.clone(),
   its library yardstick.
7. `proto_paged_tex`: the tool's main() (K10 1 + 8 times, no other
   kernel); 100% of covered pixels equal to its numpy oracle, every
   untextured pixel -1; K10 against its plain version on main's first
   call (tolerance 0), timed (bound: bytes of u, v, lm, meta, out, cov
   and the 32-B pool sectors the served texels lie in; operations 47 per
   pixel at the f32 rate).
8. A small-input cross-check per frame path (tiny atrium, its flat pools on
   `flat`; small textured bistro, with 2 cascades of 256² on the shadow
   paths, and GI on `all_no_rt`): kernels on the GPU vs plain versions on
   the CPU (the path the tests hold against chord_tpu), stats exact,
   images within 2 u8 levels.

Phases 4-5 run per frame path, then 6, 7 and 8. The line before the last
is the nvidia-smi name/power-limit line, the one before that the
per-kernel JSON (one entry per kernel and path: launches, max_abs_err,
per-frame ms / plain_ms / bound_ms / library_ms summed over the kernel's
calls in one frame, and the per-call detail, with K1, K6, K7, K8 and
K10's work stats and K3 and K9's alternating rounds;
plus each path's ms/frame and the launch floor),
and before that the tools' JSON (each repro variant's first-call seconds
and steady ms, the proto tool's coverage, match and ms); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

W, H, PW, PH = 1280, 720, 1920, 1080
FRAMES = 16
# bench.py's shadow_draw_capacity (MeshletFrameConfig's default); the far
# cascade of the bench path asks for more, so the shadow path also runs at
# a capacity that holds every cascade
BENCH_SHADOW_DRAWS = 2048
FULL_SHADOW_DRAWS = 4096
# the flat path: BASELINE config #1 at 1080p on a production-sized Sponza;
# at RendererConfig's pair capacity of 8192 its sub-tile queue runs out of
# rounds (r_cap = capacity // 4) and drops pairs on every frame
FLAT_W, FLAT_H = 1920, 1080
FLAT_DETAIL = 4
FLAT_PAIRS = 16384
TEXTURED_PATHS = ("geo_tex", "geo_shadow_atmo", "geo_tex_bricks",
                  "all_no_rt")
SHADOW_PATHS = ("geo_shadow_atmo", "all_no_rt")
# the GI stages' torch.profiler spans (renderer/meshlet_frame.py), named as
# chord_tpu's named_scopes
GI_SPANS = ("gi.ao", "gi.probe.spawn", "gi.probe.sh_reproject",
            "gi.probe.taps", "gi.probe.project_sh", "gi.probe.world_inject",
            "gi.probe.interpolate", "gi.probe.history_reproject",
            "gi.probe.spatial_filter", "gi.probe.upsample", "gi.specular",
            "gi.specular.filter")
RASTERS = ("raster", "raster_bricks", "raster_subtile")   # K1, K7, K8
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_scenes(dev, paths):
    """The scene of each path: the bench bistro (bench.py:88-100; textures
    off for `off`, on for the others) and the bench camera path
    (bench.py:112-131); `geo_shadow_atmo` and `geo_tex_bricks` reuse the
    textured build, the former with views carrying the host cascade fit
    and the LUTs (bench.py:236-256); `flat` is flat_scene()."""
    import numpy as np

    from chord_tpu_torch.asset.procedural import build_bistro_like
    from chord_tpu_torch.native import available
    from chord_tpu_torch.renderer import DeviceView
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    if not available():
        raise RuntimeError("the native Nanite builder did not load")
    cache = {}     # the two builds share their meshes' Nanite DAGs
    scenes = {}
    for path in paths:
        t0 = time.time()
        if path == "flat":
            scenes[path] = flat_scene(dev)
            continue
        if path == "all_no_rt":   # geo_shadow_atmo's scene (PATHS order)
            pools, inst, views, blend_tex = scenes["geo_shadow_atmo"]
            scenes[path] = (pools, inst,
                            views.replace(brdf_lut=brdf_lut(dev)), blend_tex)
            log(f"scene {path}: the geo_shadow_atmo scene and views, with "
                f"the env-BRDF LUT in {time.time() - t0:.2f} s")
            continue
        if path == "geo_tex_bricks":   # geo_tex's scene (PATHS order)
            scenes[path] = scenes["geo_tex"]
            log(f"scene {path}: the geo_tex scene")
            continue
        textured = path != "off"
        shadows = path == "geo_shadow_atmo"
        if shadows:     # the textured bistro of geo_tex (PATHS order)
            pools, inst, _, blend_tex = scenes["geo_tex"]
        else:
            b = build_bistro_like(detail=3, target_tris=2_600_000,
                                  textures=textured)
            pools = build_meshlet_pools(
                b, meshlet_cache=cache, nanite=True, device=dev,
                texture_pool=b.texture_pool if textured else None)
            n_src = sum(b.meshes[m].num_triangles for m, _, _ in b.instances)
            blend_tex = any(m.alpha_mode == "blend" and
                            m.base_color_texture >= 0 for m in b.materials)
        mcfg = configs(path)[1]
        cam = Camera(width=W, height=H)
        views = []
        for i in range(FRAMES):
            t = i / (FRAMES - 1)
            cam.position = np.array([-45.0 + 70.0 * t, 5.0, 4.0])
            cam.look_at(np.array([55.0, 3.0, -4.0]))
            views.append(DeviceView.from_uniform(
                cam.view_uniform(i), device=dev,
                shadow_cfg=mcfg.shadow_cfg if shadows else None))
        if shadows:
            views = with_luts(views, dev)
            log(f"scene {path}: the geo_tex scene, views with the host "
                f"cascade fit and the atmosphere LUTs in "
                f"{time.time() - t0:.2f} s")
        else:
            inst = b.frame_instances(cam, device=dev)
            rows = 2 if pools.tex_meta.shape[0] == 3 else 8
            log(f"scene {path}: {n_src} source tris, {pools.num_meshlets} "
                f"meshlets, {pools.num_pairs} pairs, "
                f"{len(b.materials)} materials, texture pages "
                f"{pools.tex_pages.shape[0] // rows} "
                f"({pools.tex_pages.numel() * 4} B, "
                f"{'compressed' if rows == 2 else 'raw'}), built in "
                f"{time.time() - t0:.2f} s (nanite on)")
        scenes[path] = (pools, inst, DeviceView.stack(views), blend_tex)
    return scenes


def flat_scene(dev, detail: int = FLAT_DETAIL, w: int = FLAT_W,
               h: int = FLAT_H, frames: int = FRAMES, jitter: bool = False):
    """The flat path's scene: build_sponza_like(detail)'s flat pools on
    `dev`, and along bench.py's Sponza camera path (bench.py:127-129) each
    frame's view uniform and instance table (rebased to that frame's
    camera) -> (pools, [instances], [view uniforms], None)."""
    import numpy as np

    from chord_tpu_torch.asset.procedural import build_sponza_like
    from chord_tpu_torch.utils.camera import Camera

    t0 = time.time()
    b = build_sponza_like(detail=detail)
    pools = b.build_pools(device=dev)
    cam = Camera(width=w, height=h)
    insts, uniforms = [], []
    for i in range(frames):
        t = i / max(frames - 1, 1)
        cam.position = np.array([-16.0 + 6.0 * t, 4.5, 3.0])
        cam.look_at(np.array([12.0, 2.0, -2.0]))
        uniforms.append(cam.view_uniform(i, jitter=jitter))
        insts.append(b.frame_instances(cam, device=dev))
    n_src = sum(b.meshes[m].num_triangles for m, _, _ in b.instances)
    pool_bytes = sum(_nbytes(getattr(pools, f)) for f in (
        "positions", "normals", "uv0", "vertex_object", "indices",
        "tri_object", "tri_valid"))
    if detail == FLAT_DETAIL:
        log(f"scene flat: build_sponza_like(detail={detail}), "
            f"{len(b.instances)} instances, {n_src} source tris "
            f"({pools.num_triangles} padded), {pools.num_vertices} "
            f"vertices, {len(b.materials)} materials, {pool_bytes} B of "
            f"pools, built in {time.time() - t0:.2f} s")
    return pools, insts, uniforms, None


def brdf_lut(dev):
    """The env-BRDF LUT, built once as bench.py does (bench.py:248:
    64 samples, a 32x32 LUT)."""
    from chord_tpu_torch.ops.brdf_lut import build_env_brdf_lut

    return build_env_brdf_lut(64, device=dev)


def with_luts(views, dev):
    """The views with the atmosphere LUTs, built once for the path's static
    sun (bench.py:239-256)."""
    from chord_tpu_torch.ops import atmosphere as atm

    p = atm.AtmosphereParams()
    t = atm.build_transmittance_lut(p, 40, device=dev)
    ms = atm.build_multiscatter_lut(p, t, dir_samples=16, steps=12)
    sky = atm.build_sky_view_lut(p, t, ms, views[0].sun_direction)
    return [v.replace(atmo_t_lut=t, atmo_ms_lut=ms, atmo_sky_lut=sky)
            for v in views]


def configs(path: str, blend_textured: bool = False, shadow_cfg=None,
            shadow_draws: int = BENCH_SHADOW_DRAWS):
    """The path's RendererConfig and MeshletFrameConfig: bench.py's for a
    rung (bench.py:171-219 at render scale 0.6667); on `flat` the flat
    frame's config and no MeshletFrameConfig."""
    from chord_tpu_torch.ops.screen_probe import ScreenProbeConfig
    from chord_tpu_torch.ops.shadow import ShadowConfig
    from chord_tpu_torch.renderer import MeshletFrameConfig, RendererConfig

    if path == "flat":
        return RendererConfig(width=FLAT_W, height=FLAT_H,
                              pair_capacity=FLAT_PAIRS, big_capacity=128,
                              subtiles=True, enable_bloom=True,
                              enable_tsr=True), None
    config = RendererConfig(width=W, height=H, post_width=PW, post_height=PH,
                            pair_capacity=8192, big_capacity=64,
                            enable_bloom=True, enable_tsr=True,
                            tsr_mode="tile")
    tex = path != "off"
    shadows = path in SHADOW_PATHS
    gi = path == "all_no_rt"     # bench.py's `all` rung, gi_rt=False
    return config, MeshletFrameConfig(
        draw_capacity=2048, masked_draw_capacity=256, occlusion=True,
        object_precull=True, textured=tex, normal_mapped=tex,
        pbr_textures=tex, alpha_masked=tex, alpha_blend=tex,
        blend_textured=blend_textured, shadows=shadows, atmosphere=shadows,
        shadow_masked=True, shadow_draw_capacity=shadow_draws,
        shadow_cfg=shadow_cfg or ShadowConfig(), gi=gi, gi_mode="probe",
        ssr=gi, trilinear=gi,
        probe_cfg=ScreenProbeConfig(rays=16, steps=6, history_mode="tile")
        if gi else None)


def history(config, mcfg, dev):
    """A fresh history for the path (with the cascade cache on the shadow
    paths and the GI state with GI on, bench.py:259-269)."""
    from chord_tpu_torch.ops.gi import GIConfig
    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    h, w = config.height, config.width
    if mcfg is None:
        return FrameHistory.empty(h, w, device=dev)
    ph, pw = config.post_height, config.post_width
    s = mcfg.shadow_cfg
    if not mcfg.shadows:
        return FrameHistory.empty(h, w, ph, pw, device=dev)
    return FrameHistory.empty(h, w, ph, pw, shadow_div=s.eval_res_div,
                              shadow_cascades=s.cascade_count,
                              shadow_res=s.resolution,
                              shadow_phase=s.temporal_phase,
                              gi_cfg=GIConfig() if mcfg.gi else None,
                              probe_tile=8 if mcfg.gi else 0, device=dev)


def run_path(path, scene, config, mcfg, hist, lo: int = 0,
             hi: Optional[int] = None):
    """Frames lo..hi-1 (default: all) of a path -> (images, history,
    per-frame stats), through the entry points a user calls:
    render_sequence_meshlet, or DeferredRenderer.render frame by frame on
    `flat`. The r.raster.bricks cvar holds for the run on `geo_tex_bricks`
    and is off otherwise."""
    import torch

    from chord_tpu_torch.renderer import (DeferredRenderer,
                                          render_sequence_meshlet)
    from chord_tpu_torch.utils.cvar import cvars

    pools, inst, views, _ = scene
    hi = FRAMES if hi is None else hi
    with cvars.override("r.raster.bricks", path == "geo_tex_bricks"):
        if path != "flat":
            return render_sequence_meshlet(pools, inst,
                                           frames(views, lo, hi), hist,
                                           config, mcfg, with_stats=True)
        r = DeferredRenderer(config)
        r.history = hist
        imgs, per = [], []
        for i in range(lo, hi):
            img, st = r.render(pools, inst[i], views[i])
            imgs.append(img)
            per.append(st)
        return (torch.stack(imgs), r.history,
                {k: torch.stack([st[k] for st in per]) for k in per[0]})


def timed(fn, reps: int):
    """-> (device ms, issue ms) per call, the mean over `reps` calls after
    one warm-up, by CUDA events. Issue ms brackets the calls as the host
    issues them: a call shorter than its host-side wrapper reads the
    wrapper's time. Device ms queues the same calls behind a device-side
    sleep longer than their issue time, so the events see them back to
    back (a call that synchronises inside still reads host gaps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        for _ in range(reps):
            fn()
        end.record()

    t0 = time.perf_counter()
    run()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    issue_ms = start.elapsed_time(end) / reps
    # twice the issue time at the H100's ~2 GHz SM clock, at most ~2 s
    torch.cuda._sleep(int(min(2.0 * issue_s, 2.0) * 2e9))
    run()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, issue_ms


def alternate(fns, rounds: int = 5, reps: int = 200):
    """Time the functions in turn, `rounds` rounds of `reps` calls each
    (timed's device ms; the order reverses every other round: A B, B A,
    ...) -> per function, its device ms per call in each round. Two
    versions are compared only this way: times taken apart drift."""
    runs = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            runs[i].append(timed(fns[i], reps)[0])
    return runs


def spread(runs) -> str:
    """'median ms (min-max of the rounds)'."""
    return (f"{statistics.median(runs):.5f} ms ({min(runs):.5f}-"
            f"{max(runs):.5f})")


def frames(views, lo: int, hi: int):
    from chord_tpu_torch.renderer import DeviceView
    return DeviceView.stack([views.frame(i) for i in range(lo, hi)])


# --- bounds -------------------------------------------------------------------

def _nbytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _ops(name: str, args, kwargs, cull: bool = True) -> float:
    """f32 operations the call's data needs (0 for pure data movement)."""
    if name in RASTERS:
        # K1 / K7 / K8: per pixel test 5 plane evaluations (4 flops) and
        # the depth divide; per cull evaluation 3 edge planes. With cull,
        # the tests their per-warp corner cull leaves on this run's data
        # (the kernels' own cull, raster.cull_tests, in K7's association
        # for K7); without, every test of the visit list.
        from chord_tpu_torch.ops import raster

        tri0, n_tri, py0, cols, r0, nrows, xoff = raster.kernel_visits(
            name, args)
        if not cull:
            return float(nrows.sum()) * cols.shape[1] * 32 * n_tri * 21
        coefT = args[5] if name == "raster_subtile" else args[4]
        tests, culls = raster.cull_tests(coefT, tri0, n_tri, py0, cols, r0,
                                         nrows, xoff)
        return tests * 21.0 + culls * 12.0
    if name == "mesh_shader":
        # per drawn triangle: 3 vertex transforms (28), 3 normal
        # transforms (15) and edge / plane setup (~100)
        count = int(args[2][0])
        return count * 128 * (3 * 28 + 3 * 15 + 100)
    if name == "paged_texture":
        layers = args[4]
        bilinear = kwargs.get("bilinear", True)
        compressed = args[1].shape[0] == 3
        per = 20 / layers.shape[0]               # shared tap math
        taps = 4 if bilinear else 1
        per += taps * 4 * (7 if compressed else 0)      # block decode
        per += 4 * 13 if bilinear else 0                # filter + round
        return float((layers >= 0).sum()) * per
    if name == "pcss":
        # per in-map pixel: 5 blocker + 6 PCF taps (rotation 6, tap
        # coordinates 4, compare / accumulate 2; PCF offsets scaled 2)
        # and the penumbra (~8)
        maps, pre, cfg = args
        taps = cfg.pcss_blocker_samples + cfg.pcss_pcf_samples
        per = taps * 12 + cfg.pcss_pcf_samples * 2 + 8
        return float((pre.cascade >= 0).sum()) * per
    if name == "proto_paged_sample":
        # K10 per pixel: remainder, scale, truncate and clamp of u and v
        # (2 x 6), the tile and slot (8), K rounds of min, compare and
        # select (3 each), K compares on resolve and the final selects (3),
        # all 32-bit, counted at the f32 rate
        u = args[2]
        return float(u.numel()) * (12 + 8 + 3 * 6 + 6 + 3)
    return 0.0


def _pcss_sectors(args) -> int:
    """The 32-B sectors of the stack K6's taps touch at in-map pixels (the
    taps of the plain version on the same inputs)."""
    import torch

    from chord_tpu_torch.ops import shadow

    maps, pre, cfg = args
    taps = []
    shadow.pcss_plain(maps, pre, cfg, tap_index=taps)
    inside = pre.cascade >= 0
    return torch.unique(torch.stack(taps)[:, inside] // 8).numel()


def _pcss_bytes(args, out) -> int:
    """What K6 must move on this call's data: the 32-B sectors of the
    stack its taps touch, the cascade plane and, at in-map pixels, the six
    other prepass planes, the per-cascade scalars and the output."""
    _, pre, _ = args
    inside = int((pre.cascade >= 0).sum())
    return (_pcss_sectors(args) * 32 + _nbytes(pre.cascade) + inside * 6 * 4 +
            _nbytes([pre.depth_range, pre.texel]) + _nbytes(out))


def _proto_bytes(args, out) -> int:
    """What K10 must move on this call's data: the 32-B sectors of the
    pool that hold the texels it serves (those the plain version serves on
    the same inputs), u, v, lm, meta and both outputs."""
    import torch

    from chord_tpu_torch.ops import proto_paged_tex

    _, meta, u, v, lm = args
    texels = []
    proto_paged_tex.paged_sample_plain(*args, texel_index=texels)
    sectors = torch.unique(texels[0] // 8).numel()
    return sectors * 32 + _nbytes([meta, u, v, lm]) + _nbytes(out)


def bound(name: str, args, kwargs, out, cull: bool = True) -> tuple:
    """-> (bound ms, "bytes" | "operations"); `cull` as in _ops."""
    if name == "pcss":
        n_bytes = _pcss_bytes(args, out)
    elif name == "proto_paged_sample":
        n_bytes = _proto_bytes(args, out)
    else:
        n_bytes = (_nbytes(args) + _nbytes(list(kwargs.values())) +
                   _nbytes(out))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = _ops(name, args, kwargs, cull) / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(name: str, args):
    """One PyTorch call computing the same function, where one exists: K3's
    rows are an index_select of the table along the flattened slot; K9 is
    a clone."""
    import torch

    if name == "fusion_barrier":
        return lambda: args[0].clone()
    if name != "row_gather":
        return None
    table, slot = args
    idx = torch.clamp(slot.reshape(-1), 0, table.shape[1] - 1).long()
    return lambda: torch.index_select(table, 1, idx)


def _dist(v) -> dict:
    """min, median, max and max/mean of a 1-D tensor of counts."""
    v = v.double()
    mean = float(v.mean())
    return dict(min=int(v.min()), median=float(v.median()), max=int(v.max()),
                max_over_mean=float(v.max()) / mean if mean else None)


def pcss_work(args) -> dict:
    """K6's work on a call's inputs: the eval pixels and those inside a
    cascade, the PCF radius over the latter (the plain version's: its
    distribution and the shares clamped at 1 and at PCF_RADIUS_MAX) and
    the 32-B stack sectors the taps touch."""
    from chord_tpu_torch.ops import shadow

    maps, pre, cfg = args
    inside = pre.cascade >= 0
    rad = shadow.pcf_radius(maps, pre, cfg)[inside]
    share = lambda b: float(b.float().mean()) if rad.numel() else None
    return dict(pixels=pre.cascade.numel(), in_map=int(inside.sum()),
                pcf_radius=dict(
                    min=float(rad.min()) if rad.numel() else None,
                    median=float(rad.median()) if rad.numel() else None,
                    max=float(rad.max()) if rad.numel() else None,
                    at_1=share(rad == 1.0),
                    at_max=share(rad == shadow.PCF_RADIUS_MAX)),
                taps=cfg.pcss_blocker_samples + cfg.pcss_pcf_samples,
                sectors=_pcss_sectors(args))


def proto_work(args) -> dict:
    """K10's work on a call's inputs: per (32,128) pixel block the
    distinct tiles its textured pixels ask for (ids below BIG; the
    palette serves K), the blocks asking for more than K, and the share of
    textured pixels the palette serves (the plain version's cov)."""
    import torch

    from chord_tpu_torch.ops import proto_paged_tex as pt

    _, meta, u, v, lm = args
    tile = pt._blocks(pt.tile_slot(meta, u, v, lm)[0])
    srt = torch.sort(torch.clamp_max(tile, pt.BIG), 1).values
    distinct = (1 + (srt[:, 1:] != srt[:, :-1]).sum(1) -
                (srt[:, -1] == pt.BIG).long())
    cov = pt.paged_sample_plain(*args)[1]
    textured = lm >= 0
    return dict(blocks=tile.shape[0], distinct_tiles_per_block=_dist(distinct),
                blocks_over_k=int((distinct > pt.K).sum()),
                textured=int(textured.sum()),
                served_share=float(cov[textured].float().mean()))


def work_stats(name: str, args) -> Optional[dict]:
    """The work line of a call: K6's and K10's inputs (pcss_work,
    proto_work) or K1 / K7 / K8's work distribution on a call's queue,
    from the plain versions' visit lists (raster.kernel_visits): per tile
    its pairs (K1, K7) or rounds (K8) and its row visits (a visit's rows:
    128 px each for K1, 32 px for K7's brick and K8's sub-tile); per block
    of the kernel's decomposition (32 columns a warp x a band of
    raster.K1_BAND / K7_BAND / K8_BAND rows, raster.band_split) its row
    visits; and the blocks launched."""
    import torch

    from chord_tpu_torch.ops import raster

    if name == "pcss":
        return pcss_work(args)
    if name == "proto_paged_sample":
        return proto_work(args)
    if name not in RASTERS:
        return None
    c, counts = args[-1], args[2]
    _, _, py0, cols, r0, nrows, _ = raster.kernel_visits(name, args)
    band = {"raster": raster.K1_BAND, "raster_bricks": raster.K7_BAND,
            "raster_subtile": raster.K8_BAND}[name]
    n_bands = c.tile_h // band
    tile = (py0 // c.tile_h) * c.tiles_x + cols[:, 0] // c.tile_w
    per_tile = torch.zeros(c.n_tiles, dtype=torch.long, device=r0.device)
    per_tile.index_add_(0, tile, nrows)
    # a K1 block holds its band of all 4 columns, a K7 / K8 block one
    # brick's or sub-tile's
    n_cols = 1 if name == "raster" else c.tile_w // 32
    unit = tile * n_cols + cols[:, 0] % c.tile_w // 32 * (n_cols > 1)
    item, b, _, n = raster.band_split(r0, nrows, band)
    blk = torch.zeros(c.n_tiles * n_cols * n_bands, dtype=torch.long,
                      device=r0.device)
    blk.index_add_(0, unit[item] * n_bands + b, n)
    return dict(tiles=c.n_tiles, queue_per_tile=_dist(counts),
                row_visits=int(nrows.sum()), row_visits_per_tile=_dist(per_tile),
                band_rows=band, blocks=blk.numel(),
                row_visits_per_block=_dist(blk))


def paged_inputs(args, kwargs) -> str:
    """K5's inputs: the share of live texels in each channel and, when
    bilinear, of footprints that read two or four of a compressed page's
    4x4 blocks (straddling a block edge in x or y, or both), by the
    kernel's tap math."""
    import torch

    _, _, n_mips, sizes, layers, uv, mip = args
    live = "/".join(f"{float((lay >= 0).float().mean()):.2f}"
                    for lay in layers)
    if not kwargs.get("bilinear", True):
        return f"live {live}"
    m = torch.clamp(mip, 0, n_mips - 1).long()
    size = torch.tensor([int(v) for v in sizes[:n_mips]],
                        device=mip.device)[m].float()
    cross = []
    for k in (0, 1):
        t = (uv[..., k] - torch.floor(uv[..., k])) * size
        b0f = torch.floor(t - 0.5)
        b0 = torch.minimum(torch.clamp(b0f, min=0.0), size - 1)
        b1 = torch.minimum(torch.clamp(b0f + 1, min=0.0), size - 1)
        tile = torch.floor((b0 + 0.5) * (1.0 / 31))
        cross.append(((b0 - 31 * tile).long() >> 2) !=
                     ((b1 - 31 * tile).long() >> 2))
    pct = lambda b: f"{100 * float(b.float().mean()):.1f}%"
    dx, dy = cross
    return (f"live {live}, footprints in 2 blocks {pct(dx ^ dy)}, "
            f"in 4 {pct(dx & dy)}")


def describe(name: str, args, kwargs) -> str:
    if name == "tile_reproject":
        planes, _, hp, wp = args
        return (f"out ({planes.shape[0]},{hp},{wp}) from padded planes "
                f"{'x'.join(map(str, planes.shape))}")
    if name == "pcss":
        maps, pre, _ = args
        return (f"stack {'x'.join(map(str, maps.shape))} eval "
                f"{'x'.join(map(str, pre.u.shape))}")
    if name == "mesh_shader":
        # a K2 time spends the poison windows' share on slack slots
        cap, live = args[0].shape[0], int(args[2][0])
        return (f"cap {cap}, live {live}, poison windows {cap - live + 1} "
                f"of {cap + 1}")
    if name == "paged_texture":
        c, h, w = args[4].shape
        mode = "bilinear" if kwargs.get("bilinear", True) else "nearest"
        return f"C={c} {mode} {h}x{w}, " + paged_inputs(args, kwargs)
    if name == "proto_paged_sample":
        pool, _, u = args[:3]
        return (f"{'x'.join(map(str, u.shape))}, pool "
                f"{pool.shape[0] // 8} tiles")
    if name == "fusion_barrier":
        x = args[0]
        return (f"{'x'.join(map(str, x.shape))} {str(x.dtype)[6:]}, "
                f"{x.numel() * x.element_size()} B")
    return " ".join("x".join(map(str, a.shape)) for a in args
                    if hasattr(a, "shape"))[:80]


# --- phases -------------------------------------------------------------------

def capture_frame(path, scene):
    """The kernel calls of one frame of the path with real history and
    both occlusion phases and, on the shadow path, with every cascade
    refreshed once before it (frame 4: its K6 call taps depth in all four
    cascades) -> (captured calls, which frame)."""
    import torch

    from chord_tpu_torch.ops import kernels

    config, mcfg = configs(path, scene[3])
    hist = history(config, mcfg, scene[0].positions.device)
    warm = mcfg.shadow_cfg.cascade_count if mcfg and mcfg.shadows else 1
    hist = run_path(path, scene, config, mcfg, hist, 0, warm)[1]
    with kernels.capture_inputs() as captured:
        run_path(path, scene, config, mcfg, hist, warm, warm + 1)
    torch.cuda.synchronize()
    return captured, f"frame {warm}"


def check_kernels(path, scene):
    """Phase 4 for one path: each kernel of the path against its plain
    version on the path's own inputs (capture_frame)."""
    return compare_kernels(path, *capture_frame(path, scene))


def compare_kernels(path, captured, what: str):
    """Each kernel of `path` against its plain version on the calls
    captured while `path` ran (none of another kernel may be among them),
    tolerance 0, and timed -> {name: JSON row without "launches"}."""
    import torch

    from chord_tpu_torch.ops import kernels

    rows = {}
    for k in kernels.KERNELS:
        calls = captured[k.name]
        if path not in k.paths:
            if calls:
                raise AssertionError(f"kernel {k.name} ran on path {path}")
            continue
        if not calls:
            raise RuntimeError(f"kernel {k.name} was not called by {path}")
        err, per_call = 0.0, []
        for i, (args, kwargs) in enumerate(calls):
            got = kernels.outputs_list(k.fn()(*args, **kwargs))
            ref = kernels.outputs_list(k.plain(*args, **kwargs))
            torch.cuda.synchronize()
            e = kernels.max_abs_err(got, ref)
            err = max(err, e)
            if e != 0.0:
                raise AssertionError(f"kernel {k.name} disagrees with its "
                                     f"plain version on {path}: {e}")
            kern = lambda: k.fn()(*args, **kwargs)
            ms, issue_ms = timed(kern, 20)
            plain_ms = timed(lambda: k.plain(*args, **kwargs),
                             3 if k.name.startswith("raster") else 10)[0]
            lib = library_call(k.name, args)
            lib_ms = runs = None
            if lib:   # kernel and library in turn: medians of the rounds
                runs = alternate([kern, lib])
                ms, lib_ms = (statistics.median(r) for r in runs)
            b_ms, b_by = bound(k.name, args, kwargs, got)
            per_call.append(dict(call=f"#{i} " + describe(k.name, args,
                                                          kwargs), ms=ms,
                                 issue_ms=issue_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms))
            if runs:
                per_call[-1].update(ms_rounds=runs[0],
                                    library_ms_rounds=runs[1])
                log(f"kernel {k.name} on {path} {per_call[-1]['call']}: "
                    f"{spread(runs[0])} vs library {spread(runs[1])}, "
                    f"medians of {len(runs[0])} alternating rounds of 200 "
                    "calls")
            work = work_stats(k.name, args)
            if work is not None:
                if k.name in RASTERS:
                    per_call[-1]["bound_all_tests_ms"] = bound(
                        k.name, args, kwargs, got, cull=False)[0]
                per_call[-1]["work"] = work
                log(f"work {k.name} on {path} {per_call[-1]['call']}: "
                    f"{json.dumps(work)}")
        if k.name == "tile_reproject" and len(calls) > 1:
            # K4's calls of a frame (TSR's and the GI history's) in turns
            runs = alternate([lambda a=a, kw=kw: k.fn()(*a, **kw)
                              for a, kw in calls])
            for c, r in zip(per_call, runs):
                c.update(ms=statistics.median(r), ms_rounds=r)
            log(f"kernel {k.name} on {path}, its calls in turns: " +
                "; ".join(f"[{c['call']}] {spread(r)}"
                          for c, r in zip(per_call, runs)) +
                f", medians of {len(runs[0])} alternating rounds of 200 "
                "calls")
        tot = lambda key: sum(c[key] for c in per_call)
        by = max(per_call, key=lambda c: c["bound_ms"])["bound_by"]
        rows[k.name] = dict(
            name=k.name, path=path, route="cuda", source=k.source,
            replaces=k.replaces, max_abs_err=err, ms=tot("ms"),
            plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"), bound_by=by,
            library_ms=(tot("library_ms") if per_call[0]["library_ms"]
                        is not None else None),
            calls_per_frame=len(per_call), per_call=per_call)
        if "bound_all_tests_ms" in per_call[0]:
            rows[k.name]["bound_all_tests_ms"] = tot("bound_all_tests_ms")
        log(f"kernel {k.name} on {path}: {len(calls)} calls of {what} "
            f"compared, max |kernel - plain| = {err} (tolerance 0); per "
            "call: " +
            "; ".join(f"[{c['call']}] {c['ms']:.4f} ms (issue-paced "
                      f"{c['issue_ms']:.4f}) vs plain "
                      f"{c['plain_ms']:.4f}, bound {c['bound_ms']:.4f} "
                      f"({c['bound_by']})" +
                      (f", every test {c['bound_all_tests_ms']:.4f}"
                       if "bound_all_tests_ms" in c else "") +
                      (f", library {c['library_ms']:.4f}"
                       if c["library_ms"] is not None else "")
                      for c in per_call))
    return rows


def check_shadow_draws(k2_calls, stats, mcfg, fail_at_capacity: bool):
    """Per cascade and bucket, the worst frame's shadow draws: drawn (the
    live count of the depth-pass K2 calls, in frame order: frame f
    refreshes cascade f % N, opaque then masked casters), asked for (drawn
    plus what the cull dropped past its capacity, from the frame's stats)
    and the capacity. Fails when a shadow bin drops pairs and, with
    `fail_at_capacity`, when a cascade's draws reach their capacity."""
    s = mcfg.shadow_cfg
    calls = [(args[0].shape[0], int(args[2])) for args, _ in k2_calls
             if not args[9]]                      # backface_cull=False
    over = {kind: stats[f"shadow_{kind}"].tolist()
            for kind in ("draw_overflow", "masked_overflow")}
    worst, i = {}, 0
    for f in range(FRAMES):
        k = f % s.cascade_count
        kinds = [("opaque", "draw_overflow")]
        if mcfg.alpha_masked and mcfg.shadow_masked and \
                k < mcfg.shadow_masked_cascades:
            kinds.append(("masked", "masked_overflow"))
        for kind, stat in kinds:
            cap, n = calls[i]
            key = f"cascade {k} {kind}"
            w = worst.get(key, (0, 0))
            worst[key] = (max(w[0], n), max(w[1], n + over[stat][f]), cap)
            i += 1
    if i != len(calls):
        raise AssertionError(f"{len(calls)} shadow K2 calls, expected {i}")
    dropped = int(stats["shadow_bin_overflow"].max())
    log(f"shadow draws at capacity {mcfg.shadow_draw_capacity} (worst "
        "frame: drawn / asked for / capacity): " +
        ", ".join(f"{k} {n}/{a}/{cap}" for k, (n, a, cap) in worst.items()) +
        f"; pairs dropped by the shadow bins: {dropped}")
    if dropped > 0:
        raise AssertionError(f"the shadow bins dropped {dropped} pairs")
    full = [f"{k} ({a} asked for, capacity {cap})"
            for k, (n, a, cap) in worst.items() if n >= cap]
    if full and fail_at_capacity:
        raise AssertionError("shadow draws at capacity: " + ", ".join(full))
    if full:
        log("casters dropped at bench.py's capacity, as chord_tpu drops them "
            "at this config: " + ", ".join(full))


def check_gi_history(path, hist, config, mcfg) -> None:
    """The GI state after a run: chord_tpu's shapes, probes on geometry
    that gathered samples, a world cache that took probes (a cascade takes
    them only where its clipmap holds converged probes), non-negative
    diffuse and specular histories that are not all zero."""
    from chord_tpu_torch.ops.gi import GIConfig, sh_size

    gcfg = mcfg.gi_cfg or GIConfig()
    h, w = config.height, config.width
    want = {"gi_cache": sh_size(gcfg), "probe_sh": (h // 8, w // 8, 28),
            "probe_depth": (h // 8, w // 8), "gi_diffuse": (h // 2, w // 2, 3),
            "gi_specular": (-(-h // gcfg.sample_res_div),
                            -(-w // gcfg.sample_res_div), 3)}
    for name, shape in want.items():
        if tuple(getattr(hist, name).shape) != shape:
            raise AssertionError(f"{path}: history {name} is "
                                 f"{tuple(getattr(hist, name).shape)}, not "
                                 f"{shape}")
    n = hist.probe_sh[..., 27]
    lit = (hist.gi_cache[..., 27] > 0).float().mean(dim=1)
    log(f"{path}: probes with samples {float((n > 0).float().mean()):.4f} "
        f"(median count {float(n.median()):.2f}), lit cache probes per "
        f"cascade {[round(float(x), 5) for x in lit]}, gi_diffuse in "
        f"[{float(hist.gi_diffuse.min()):.4f}, "
        f"{float(hist.gi_diffuse.max()):.4f}], gi_specular in "
        f"[{float(hist.gi_specular.min()):.4f}, "
        f"{float(hist.gi_specular.max()):.4f}]")
    on_geometry = hist.probe_depth > 0
    if not float((n[on_geometry] > 8).float().mean()) > 0.5:
        raise AssertionError(f"{path}: most probes on geometry hold <= 8 "
                             "samples")
    if not bool((lit > 0).any()):
        raise AssertionError(f"{path}: the world cache took no probe")
    for name in ("gi_diffuse", "gi_specular"):
        x = getattr(hist, name)
        if float(x.min()) < 0.0 or not float(x.max()) > 0.0:
            raise AssertionError(f"{path}: history {name} is negative or 0")


def main_path(path, scene, card: str,
              shadow_draws: int = BENCH_SHADOW_DRAWS):
    """Phase 5 for one path: the 16-frame sequence, counted, checked and
    timed, at bench.py's shadow draw capacity unless `shadow_draws` is
    given (and then no cascade may reach it)."""
    import torch

    from chord_tpu_torch.ops import kernels

    config, mcfg = configs(path, scene[3], shadow_draws=shadow_draws)
    bench = shadow_draws == BENCH_SHADOW_DRAWS
    label = path if bench else f"{path} at shadow_draw_capacity {shadow_draws}"
    hist0 = history(config, mcfg, scene[0].positions.device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    with kernels.capture_inputs() as captured:
        imgs, hist, stats = run_path(path, scene, config, mcfg, hist0)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = kernels.launch_counts()
    worst = {k: int(v.max()) for k, v in stats.items()}
    log(f"{label} path: {FRAMES} frames in {first_s:.3f} s (first run), "
        f"worst-frame stats {worst}, launches {launches}")
    if path == "flat":
        log(f"flat path per frame: drawn_tris {stats['drawn_tris'].tolist()}"
            f", binned_pairs {stats['binned_pairs'].tolist()}, "
            f"bin_overflow {stats['bin_overflow'].tolist()} (pair capacity "
            f"{config.pair_capacity})")
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        if worst.get(k, 0) != 0:
            raise AssertionError(f"{path}: worst-frame {k} = {worst[k]}")
    if int(stats["drawn_tris"].min()) <= 0:
        raise AssertionError(f"{path}: a frame drew no triangles")
    out_hw = ((config.post_height or config.height,
               config.post_width or config.width) if mcfg
              else (config.height, config.width))
    if tuple(imgs.shape) != (FRAMES, *out_hw, 3):
        raise AssertionError(f"{path}: image shape {tuple(imgs.shape)}")
    last = imgs[-1].float()
    if float(last.std()) < 1.0:
        raise AssertionError(f"{path}: the final image is constant")
    for name in ("depth", "tsr_color", "exposure", "hzb_flat",
                 "shadow_mask", "shadow_maps", "depth_range", "gi_cache",
                 "probe_sh", "probe_depth", "gi_diffuse", "gi_specular"):
        if not bool(torch.isfinite(getattr(hist, name)).all()):
            raise AssertionError(f"{path}: history {name} is not finite")
    for k in kernels.KERNELS:
        n = launches[k.name]
        if path in k.paths and n <= 0:
            raise AssertionError(f"kernel {k.name} was not launched on the "
                                 f"{path} path")
        if path not in k.paths and n != 0:
            raise AssertionError(f"kernel {k.name} ran on the {path} path")
    for name, n in kernels.EXPECTED_LAUNCHES[path].items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on {path}, expected {n}")
    if path in TEXTURED_PATHS and int(stats["draws_masked"].max()) <= 0:
        raise AssertionError("no masked draws on any frame")
    k2_calls = captured["mesh_shader"]
    del captured
    if mcfg is not None and mcfg.gi:
        check_gi_history(path, hist, config, mcfg)
    if mcfg is not None and mcfg.shadows:
        check_shadow_draws(k2_calls, stats, mcfg, fail_at_capacity=not bench)
        m = hist.shadow_mask
        cover = [round(float((c > 0).float().mean()), 4)
                 for c in hist.shadow_maps]
        log(f"{path}: shadow mask {tuple(m.shape)} in [{float(m.min()):.4f}"
            f", {float(m.max()):.4f}], shadowed (< 0.5) "
            f"{float((m < 0.5).float().mean()):.4f}; cascade coverage "
            f"{cover}")
        if not float(m.min()) < 0.5 < float(m.max()):
            raise AssertionError(f"{path}: the shadow mask is not both lit "
                                 "and shadowed")

    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        again = run_path(path, scene, config, mcfg, hist0)
        torch.cuda.synchronize()
        times.append((time.time() - t0) / FRAMES * 1000.0)
        if i == 0 and mcfg is not None and mcfg.gi:
            # the world cache sums probes by scatter-add: same inputs, same
            # cache, run after run?
            diff = {f: float((getattr(again[1], f) - getattr(hist, f))
                             .abs().max()) for f in ("gi_cache", "probe_sh")}
            log(f"{path} run to run: images equal "
                f"{bool(torch.equal(again[0], imgs))}, max |gi_cache "
                f"difference| {diff['gi_cache']}, probe_sh "
                f"{diff['probe_sh']}")
        del again
    ms = statistics.median(times)
    log(f"{label} path: {ms:.3f} ms/frame median of 3 runs "
        f"({', '.join(f'{t:.3f}' for t in times)}; spread "
        f"{max(times) / min(times):.3f}x; {FRAMES} frames each, "
        f"synchronize-bounded host clock) on {card}; mean u8 of the last "
        f"frame {float(last.mean()):.3f}")
    return {k.name: launches[k.name] for k in kernels.KERNELS
            if path in k.paths}, dict(median=ms, runs=times)


def profile(path, scene, n: int = 4) -> None:
    """Optional (--profile): torch.profiler over `n` frames after a
    warm-up; prints the device time by kernel and the device's busy share
    of the host wall time. Busy time and device ops are the device events'
    (kernels, copies and sets): an operator's row repeats its kernels'
    time, as the table's own total leaves it out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    config, mcfg = configs(path, scene[3])
    hist = history(config, mcfg, scene[0].positions.device)
    run_path(path, scene, config, mcfg, hist, 0, n)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_path(path, scene, config, mcfg, hist, 0, n)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = prof.key_averages()
    # a record_function span may also appear as a device-side annotation:
    # it is not device work of its own
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.key not in GI_SPANS]
    dev_us = sum(e.self_device_time_total for e in on_device)
    n_launch = sum(e.count for e in on_device)
    log(events.table(sort_by="self_device_time_total", row_limit=25))
    log(f"profile {path}: {n} frames, host wall "
        f"{wall * 1000 / n:.3f} ms/frame (profiler on), device busy "
        f"{dev_us / 1000 / n:.3f} ms/frame = {dev_us / 1e6 / wall:.4f} "
        f"of wall, {n_launch / n:.1f} device ops/frame")
    spans = {e.key: e for e in events
             if e.key in GI_SPANS and e.device_type == DeviceType.CPU}
    if spans:
        # device: the kernels launched inside the span; host: its wall
        log(f"profile {path} GI stages per frame (device ms / host ms): " +
            ", ".join(f"{name} {spans[name].device_time_total / 1000 / n:.4f}"
                      f" / {spans[name].cpu_time_total / 1000 / n:.3f}"
                      for name in GI_SPANS if name in spans))


def _agree(got, ref, variant: str):
    """-> (fraction of elements within 1e-5, max |got - ref|) of a repro
    variant's outputs on the card and on the CPU."""
    import numpy as np

    fr, worst = 1.0, 0.0
    for a, b in zip(got, ref):
        if a.shape != b.shape or not bool(a.isfinite().all()):
            raise AssertionError(f"repro {variant}: output {tuple(a.shape)} "
                                 f"(CPU {tuple(b.shape)}) or not finite")
        d = np.abs(a.double().numpy() - b.double().numpy())
        fr, worst = min(fr, float((d <= 1e-5).mean())), max(worst, d.max())
    return fr, float(worst)


def repro_eval_path(dev, card):
    """Phase 6: every variant of the port's repro_eval_kernel tool on the
    card through its run_variant (one call at frame 1, three steady), the
    launch counts set to 0 before each variant and read after it (K9
    launched 1 + 3 times by tm_pallas, no kernel by any other variant);
    each variant's first outputs against the same variant on the CPU
    (>= 99.9% of elements within 1e-5: CUDA's cos/sin/exp may move a PCSS
    tap across a texel edge; the scan means within 5e-3); then K9 against
    its plain version on tm_pallas's first call, timed. -> (kernel rows,
    {variant: timings})."""
    import torch

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.tools import repro_eval_kernel as tool

    steady = 3
    timings, k9_calls = {}, None
    for v in tool.VARIANTS:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with kernels.capture_inputs() as captured:
            res = tool.run_variant(v, dev, steady)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {k.name: 0 for k in kernels.KERNELS}
        if v == "tm_pallas":
            want["fusion_barrier"] = 1 + steady
            k9_calls = {k: calls[:1] for k, calls in captured.items()}
        if counts != want:
            raise AssertionError(f"repro {v}: launches {counts}, expected "
                                 f"{want}")
        run, args = tool.build(v, "cpu")
        extra = ((torch.zeros((tool.HP, tool.WP)),) if v == "tm_hist"
                 else ())
        out = run(*args, 1, *extra)
        cpu = list(out) if isinstance(out, tuple) else [out]
        frac, worst = _agree(res["out"], cpu, v)
        ok = worst <= 5e-3 if v.startswith("scan_") else frac >= 0.999
        log(f"repro {v} on {card}: first call {res['first_s']:.3f} s, "
            f"steady {res['steady_ms']:.3f} ms, launches "
            f"{ {k: n for k, n in counts.items() if n} }; vs CPU: "
            f"{frac:.6f} within 1e-5, max |diff| {worst:.3g}")
        if not ok:
            raise AssertionError(f"repro {v}: the card and the CPU disagree")
        timings[v] = dict(first_s=res["first_s"], steady_ms=res["steady_ms"],
                          sum=res["sum"], within_1e5_of_cpu=frac)
    rows = compare_kernels("repro_eval", k9_calls, "tm_pallas frame 1")
    rows["fusion_barrier"]["launches"] = 1 + steady
    return rows, timings


def proto_paged_tex_path(card):
    """Phase 7: the port's proto_paged_tex tool at its own size (1056x1920,
    360-tile pool) through main(), the launch counts set to 0 before and
    read after (K10 1 + REPS times, no other kernel); 100% of the covered
    pixels must equal the tool's numpy oracle and every untextured pixel be
    -1; then K10 against its plain version on main's first call, timed.
    -> (kernel rows, the tool's result)."""
    import torch

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.tools import proto_paged_tex as tool

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with kernels.capture_inputs() as captured:
        res = tool.main()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k.name: 0 for k in kernels.KERNELS}
    want["proto_paged_sample"] = 1 + tool.REPS
    log(f"proto_paged_tex on {card}: covered {res['covered']:.6f}, exact "
        f"match among covered {res['match']:.6f}, untextured all -1 "
        f"{res['untextured_ok']}, {res['ms']:.4f} ms per call (host clock, "
        f"{tool.REPS} calls), launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    if counts != want:
        raise AssertionError(f"proto_paged_tex: launches {counts}, expected "
                             f"{want}")
    if res["match"] != 1.0 or not res["untextured_ok"] or \
            not res["covered"] > 0.0:
        raise AssertionError("proto_paged_tex: the sampler disagrees with "
                             "the numpy oracle")
    rows = compare_kernels("proto_paged_tex",
                           {k: calls[:1] for k, calls in captured.items()},
                           "main's first call")
    rows["proto_paged_sample"]["launches"] = want["proto_paged_sample"]
    return rows, {k: res[k] for k in ("hw", "pool_bytes", "covered", "match",
                                      "ms")}


def small_cross_check(path, dev):
    """Phase 8 for one path: tiny inputs, kernels on the GPU vs plain
    versions on the CPU."""
    import numpy as np
    import torch

    from chord_tpu_torch.asset.procedural import (build_bistro_like,
                                                  build_sponza_like)
    from chord_tpu_torch.ops.shadow import ShadowConfig
    from chord_tpu_torch.renderer import DeviceView, RendererConfig
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    tex = path in TEXTURED_PATHS
    shadows = path in SHADOW_PATHS
    mcfg = None
    if path == "flat":
        cfg = RendererConfig(width=128, height=64, pair_capacity=4096,
                             big_capacity=128, subtiles=True)
    else:
        cfg = RendererConfig(width=128, height=64, post_width=192,
                             post_height=96, pair_capacity=4096,
                             big_capacity=128, tsr_mode="tile")
        _, mcfg = configs(path, shadow_cfg=ShadowConfig(cascade_count=2,
                                                        resolution=256))
        mcfg = mcfg._replace(draw_capacity=1024)
    out = {}
    for d in (dev, torch.device("cpu")):
        if path == "flat":
            scene = flat_scene(d, detail=1, w=128, h=64, frames=3,
                               jitter=True)
        else:
            b = (build_bistro_like(detail=1, textures=True) if tex
                 else build_sponza_like(detail=1))
            cam = Camera(width=128, height=64)
            vs = []
            for i in range(3):
                if tex:
                    cam.position = np.array([-45.0 + 70.0 * i / 15, 5.0,
                                             4.0])
                    cam.look_at(np.array([55.0, 3.0, -4.0]))
                else:
                    cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
                    cam.look_at(np.array([10.0, 2.0, 0.0]))
                vs.append(DeviceView.from_uniform(
                    cam.view_uniform(i, jitter=True), device=d,
                    shadow_cfg=mcfg.shadow_cfg if shadows else None))
            if shadows:
                vs = with_luts(vs, d)
            if mcfg.gi:
                lut = brdf_lut(d)
                vs = [v.replace(brdf_lut=lut) for v in vs]
            scene = (build_meshlet_pools(
                b, device=d, texture_pool=getattr(b, "texture_pool", None)),
                b.frame_instances(cam, device=d), DeviceView.stack(vs), None)
        imgs, _, st = run_path(path, scene, cfg, mcfg,
                               history(cfg, mcfg, d), 0, 3)
        out[d.type] = (imgs.cpu().numpy().astype(np.int32),
                       {k: v.cpu().tolist() for k, v in st.items()})
    diff = np.abs(out["cuda"][0] - out["cpu"][0])
    frac = float((diff <= 2).mean())
    log(f"small cross-check {path} (GPU kernels vs CPU plain): stats equal "
        f"{out['cuda'][1] == out['cpu'][1]} {out['cuda'][1]}, max u8 diff "
        f"{int(diff.max())}, within 2 levels {frac}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"stats differ: {out['cuda'][1]} vs "
                             f"{out['cpu'][1]}")
    if frac < 0.999:
        raise AssertionError(f"only {frac} of u8 values within 2 levels")
    if tex and max(out["cuda"][1]["draws_masked"]) <= 0:
        raise AssertionError("the small textured scene drew no masked draws")


def ptxas_lines(sources=("pcss.cu", "proto_paged_tex.cu")) -> None:
    """Registers, shared memory and spills of each kernel function of the
    sources, as ptxas reported them when the library was built."""
    from chord_tpu_torch.ops import _cuda

    report = _cuda.ptxas_report()
    for src in sources:
        usage = _cuda.ptxas_usage(report.get(src, ""))
        if not usage:
            log(f"ptxas {src}: no report beside the library")
        names = _demangle([u["function"] for u in usage])
        for u, name in zip(usage, names):
            log(f"ptxas {src} {name}: {u.get('registers')} registers, "
                f"{u.get('smem')} B shared, spill stores "
                f"{u.get('spill_stores')} B, loads {u.get('spill_loads')} B")


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        lines = [n.replace("(anonymous namespace)::", "").split("(")[0]
                 for n in out.stdout.splitlines()]
        return lines if len(lines) == len(names) else names
    except OSError:
        return names


def launch_floor(card: str) -> float:
    """The device time of an empty one-block launch (csrc/launch_floor.cu),
    timed as the kernels are -> ms."""
    from chord_tpu_torch.ops import _cuda

    ms, issue_ms = timed(lambda: _cuda.launch("chord_launch_floor",
                                              _cuda.stream()), 20)
    log(f"launch floor: {ms:.5f} ms device (issue-paced {issue_ms:.5f}) "
        f"for an empty one-block grid on {card}")
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    # the port must come from this checkout (fails, printing nothing,
    # where chip_smoke.py stands alone)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chord_tpu_torch.ops import _cuda, raster
    from chord_tpu_torch.ops.kernels import PATHS, TOOL_PATHS

    smi = card_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    dev = torch.device("cuda", 0)
    t_start = t0 = time.time()
    path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"kernels built: {path.name} from {len(_cuda.sources())} sources in "
        f"{time.time() - t0:.2f} s")
    # the band rule, the work stats and the cull count mirror these
    lib = _cuda.lib()
    bands = (lib.chord_raster_tiles_band(), lib.chord_raster_bricks_band(),
             lib.chord_raster_subtile_band(), lib.chord_raster_subtile_rows())
    if bands != (raster.K1_BAND, raster.K7_BAND, raster.K8_BAND,
                 raster.WARP_ROWS):
        raise AssertionError(f"kernel bands {bands} != raster's constants")
    ptxas_lines()
    floor_ms = launch_floor(smi)

    scenes = bench_scenes(dev, PATHS)
    rows, ms_per_frame = [], {}
    for p in PATHS:
        krows = check_kernels(p, scenes[p])
        launches, ms_per_frame[p] = main_path(p, scenes[p], smi)
        if p == "geo_shadow_atmo":
            ms_per_frame[f"{p} shadow_draw_capacity {FULL_SHADOW_DRAWS}"] = \
                main_path(p, scenes[p], smi, FULL_SHADOW_DRAWS)[1]
        for name, n in launches.items():
            krows[name]["launches"] = n
        rows += list(krows.values())
        if "--profile" in sys.argv[1:]:
            profile(p, scenes[p])
    tool_phase = {"repro_eval": lambda: repro_eval_path(dev, smi),
                  "proto_paged_tex": lambda: proto_paged_tex_path(smi)}
    tools = {}
    for p in TOOL_PATHS:
        krows, tools[p] = tool_phase[p]()
        rows += list(krows.values())
    for p in PATHS:
        small_cross_check(p, dev)
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"tools": tools}))

    order = ("name", "path", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "bound_all_tests_ms", "library_ms", "calls_per_frame",
             "per_call")
    print(json.dumps({"kernels": [{k: r[k] for k in order if k in r}
                                  for r in rows],
                      "ms_per_frame": ms_per_frame,
                      "launch_floor_ms": floor_ms}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
