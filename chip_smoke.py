#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (chord_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the default run
    python3 chip_smoke.py --profile    # + a torch.profiler breakdown per path

Twenty paths, sixteen one-process frame paths, two strip-parallel
frame paths (phase 12) and two tool paths, and the apps (phase 11).
Three are the bench's
`off`, `geo_tex` and `geo_shadow_atmo` rungs (bench.py:35-54): the
1280x720 render of the 2.6M-triangle procedural bistro (Nanite LOD cut),
built as bench.py builds it for every rung (textures=True, with the
bench texture pool: 12 layers of 256², block-compressed pages), upscaled
to 1920x1080 by tile-mode TSR, bloom and the ACES tonemap; `off` renders
it with the texture flags off (its leaves opaque, no page sampled);
`geo_tex` adds base / normal / metal-rough maps, the alpha-masked bucket
and the blend bucket; `geo_shadow_atmo`
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
TSR history and the half-res GI history). `all` is the bench's `all` rung
itself: `all_no_rt` with gi_rt=True, rt_rays=2 and the scene BVH built
once on the host over the instances' bounding spheres
(build_scene_bvh(pools, b.frame_instances(cam), granularity="object") with
the camera where bench.py:221-233 builds it, before the camera path), so
2 rays a screen probe join its taps and SSR's misses trace the BVH (the
dense route: every ray against every object sphere, in 512-sphere chunks;
no kernel of its own). Two paths run chord_tpu's other GI modes on
`all`'s scene, views and LUTs, each with a BVH built as
MeshletRenderer.render builds it (from the path's own instance table, at
its granularity, once): `all_ddgi` is `all` with gi_mode="ddgi" and
DDGIConfig() (4 cascades of 16x8x16 probes, 32 rays, one (cascade,
phase) slice of 512 probes updated a frame) over a meshlet BVH, the
viewer's `--gi --gi-mode ddgi --gi-rt` (no screen probes: K4 runs only
for TSR); `all_exact` is `all` over a triangle BVH of the root cut
(rt_granularity="triangle", the viewer's `--rt-exact`), with RTAO
(GIConfig(ao_mode="rtao"): 4 rays a pixel at 640x360) and the probe march
(ScreenProbeConfig(trace_mode="march", rays=16, steps=6)): its 6 traces
a frame take the lock-step BVH scan (the root cut is far above
DENSE_TRI_LIMIT triangles), so its sequence is 4 frames long, not 16
(kernels.RUN_FRAMES), and timed once, not three times. `flat` is the flat
DeferredRenderer frame (BASELINE config #1: object
frustum cull, every triangle of the visible objects, deferred PBR) of
build_sponza_like(detail=4) (367,104 padded triangles) at 1920x1080 along
bench.py's Sponza camera path (bench.py:127-129), with
RendererConfig(subtiles=True): the sub-tile raster (K8) at pair capacity
16384 (the class default 8192 drops pairs on this scene), big capacity
128, bloom and gather-mode TSR. Two paths run the meshlet frame's other
branches: `geo_tex_native` is `geo_tex`'s scene, camera path and textures
rendered natively at 1920x1080 (render size = post size) with gather-mode
TSR (TSR without upscale) and masked_layers=2 (the masked depth peel: K1
with a z-clip plane and attributes, a second alpha test), at bench.py's
pair capacity of 8192 (its worst queue holds 2,320 pairs at 1080p;
phase 5 prints each path's worst queue); `off_no_occlusion`
is `off` with occlusion=False (one cull, no HZB, one raster),
object_precull=False, global-mode TSR upscale and the HDR10 output.
`geo_shadow_atmo_split` is `geo_shadow_atmo` with ShadowConfig(pipelined=
True), run as bench.py:272-281 runs such a config, through
render_sequence_split: each frame exports its PCSS inputs and lights with
last frame's mask, then shadow_service_step refreshes the cascade,
evaluates PCSS (K6) and blends (the shadows are one frame late, so its
images differ from the inline path's by design). `interior` is BASELINE
config #4, bench.py --scene interior at the `all` rung:
build_bistro_interior(detail=3), an enclosed room lit through one window,
on bench.py's interior camera path (bench.py:119-121), with the `all`
rung's shadows, atmosphere, screen-probe GI, SSR and the object BVH built
as bench.py:221-233 builds it (the rung's textured flags run on a scene
without a texture pool: K5 samples the empty pool). `nanite` is BASELINE
config #3, bench.py --scene nanite at the `off` rung:
build_nanite_stress(rings=48), 100 instances of one ~9.2k-triangle sphere
(~0.9M source triangles) whose Nanite cut decides what is drawn, on the
orbit path (bench.py:122-126). Both render 1280x720, upscaled to
1920x1080 by tile TSR. `all_4k` is BASELINE config #5, the `all` rung at
bench.py --width 3840 --height 2160 (bench.py:171-186): `all`'s scene,
object BVH and LUTs with the camera path at 2560x1440, upscaled by tile
TSR to 3840x2160, at bench.py's 4K capacities (draws 4096, pairs 24576,
big windows 128); where those drop anything (its worst-frame overflows
are printed) it runs again at FULL_4K_CAPS with the shadow draws at 4096,
where nothing may overflow. `all_cache` is `all` with gi_mode="cache",
the viewer's `--gi --gi-mode cache --gi-rt`: the world SH cache takes the
frame's lit surfels (gi.inject), no screen probes run (K4 only for TSR)
and only SSR's misses trace the BVH. The
tool paths are the port's
chord_tpu_torch/tools: `repro_eval` runs all 22 variants of the
shadow-evaluate fault bisection at its bench shapes (`tm_pallas` puts the
fusion barrier K9 between the evaluate and the temporal blend), and
`proto_paged_tex` the paged-texture prototype (palette sampler K10) at its
own size, 1056x1920.

Phases (any failure raises and the script exits non-zero):

1. Requires a CUDA device; prints the card's name and power limit, and
   the host's C library.
2. Builds the eleven hand-written kernels (chord_tpu_torch/csrc/*.cu, one
   nvcc per source, all at once) into build/kernels/, prints the
   registers, shared memory and spills ptxas reports for K5, K6 and K10,
   times the launch floor: an empty one-block grid (csrc/launch_floor.cu)
   timed as the kernels are, the least time any launched kernel takes,
   and holds K5 to its plain version on the page-id edge cases of
   tests/paged_palette_cases.py (ids beyond the pool and below 0, K and
   K + 1 distinct ids a block, a pool wider than the kernel's bitmap,
   untextured and partial blocks, a mip too large for the kernel's FP32-
   pipe conversions), bilinear and nearest, coverage too. Then the
   sincos kernel (csrc/sincos.cu: chord_tpu's XLA f32 sin and cos, the C
   library's sinf / cosf, which the frame's PCSS disk rotation, GGX
   azimuth and RTAO fan take on the card): bit-equal to its plain
   version on every f32 in (-120, 120) in chunks and on 10^6 seeded
   inputs of every range, those also counted against this host's C
   library, and timed at a 1280x720 plane in turns with torch.sin +
   torch.cos (sincos_checks). The powf kernel (csrc/powf.cu: chord_tpu's
   XLA f32 power, the C library's powf, which the specular filters' edge
   weights take on the card) likewise: bit-equal to its plain version on
   every f32 in [2^-126, 1] with y = 8 and on seeded inputs of other
   exponents, those also counted against this host's C library (with
   XLA's flush to zero), and timed at the firefly clamp's eight 90x160
   weight planes in turns with torch.pow (powf_checks).
3. Builds the scenes (the two bistros share the Nanite DAG of their common
   meshes; the shadow, split and brick paths reuse the textured one; the
   flat Sponza pools with a per-frame instance table; the interior and the
   Nanite field) and the LUTs, and prints build time, meshlets, page count
   and pool bytes.
4. Kernel vs plain version, per path: renders the path's first frame
   (on the shadow path its first four, so every cascade holds depth),
   then records every kernel call's inputs through the next frame, and
   runs each kernel and its plain PyTorch version on those calls (K1
   raster on the three bench rungs; K2 mesh shader, K3 row gather, K4 tile
   reproject on every meshlet path, both of its calls on the screen-probe
   paths `all_no_rt`, `all` and `all_exact`; K5 paged texture sampler on
   the textured paths, with the masked shadow casters on the shadow
   paths; K6 PCSS on `geo_shadow_atmo` and the GI paths; K7 brick raster on
   `geo_tex_bricks`; K8 sub-tile raster on `flat`).
   Tolerance 0: the kernels are built with -fmad=false and round every
   operation as the plain versions do. Times each call (CUDA events,
   inputs L2-warm, queued behind a device-side sleep so the events see the
   device's time and not the host's issue rate; the issue-paced time is
   kept beside it), computes its bound (the larger of the bytes it must
   move over 3.35 TB/s and the f32 operations this run's data needs over
   67 TFLOP/s; the bytes are its inputs and outputs, except that K6 counts
   the 32-B sectors of the stack its taps touch, not the whole stack, and
   K4 the history pixels its tiles' taps touch, not the whole history; K1,
   K7 and K8's operations are the pixel tests their exact per-warp corner
   cull leaves on this run's queue x 21 flops plus 12 per cull evaluation
   (raster.cull_tests, K7's in its own association), with the bound of
   every test of the visit list kept beside it as `bound_all_tests_ms`)
   and, for K3, K4 and K9, times one PyTorch call of the same function
   (torch.index_select of the same rows, a border-clamped bilinear
   F.grid_sample on a grid built from K4's tile table, x.clone()) as a
   library yardstick, kernel and library in turn over 5 rounds of 200
   calls (medians, with the rounds' spread); K4's two calls of a GI frame
   are timed in turn the same way. For each K1, K7 and K8 call it
   prints a `work` line, off the timed window: per tile the pairs (K1, K7)
   or rounds (K8) and the row visits, per block of the kernels'
   decomposition (32 columns a warp x raster.K1_BAND / K7_BAND / K8_BAND
   rows, raster.band_split) the row visits, and the blocks launched; for
   K6 the in-map pixels, the PCF radius's distribution and the stack
   sectors the taps touch; for K10 the distinct tiles a pixel block asks
   for and the share of textured pixels the palette serves; for K5 the
   share of textured texels its page palette serves, the share the
   fallback mip serves and the rest (the average colour), per call. The
   sincos kernel on its calls of the frame (the PCSS rotation on the
   shadow paths, the GGX azimuth on the GI paths, RTAO's four on
   `all_exact`), f64 operations at 34 TFLOP/s in its bound and
   torch.sin + torch.cos as its yardstick; the powf kernel on its two
   calls a frame on the GI paths (f64 operations too; torch.pow its
   yardstick).
5. Each path's 16-frame sequence (4 frames on `all_exact`;
   render_sequence_meshlet(with_stats=True);
   on `flat`, DeferredRenderer.render frame by frame), with every launch
   count set to 0 just before and read just after: worst-frame overflows
   0, drawn triangles > 0, a finite non-constant image, every kernel of
   the path launched and no other (kernels.EXPECTED_LAUNCHES: K4 16
   times, 32 on the screen-probe paths; K5 32 times on `geo_tex` and
   `geo_tex_bricks`, 40 on the shadow paths: 32 plus the masked casters
   of the 8 frames that refresh cascade 0 or 1; K6 16 times; K7 64 times;
   K8 16 times; the sincos kernel kernels.SINCOS_PER_FRAME a frame, the
   powf kernel kernels.POWF_PER_FRAME),
   K5's palette per path (the share of textured texels
   its calls served from the palette, from the fallback mip and by the
   average colour, by channel count), masked draws on some frame of the
   textured paths, a
   finite cascade cache and shadow mask, on the GI paths the GI history
   (chord_tpu's shapes, probes with samples or every DDGI probe traced, a
   world cache that took probes or surfels, non-negative non-zero diffuse
   and specular histories) and, from a second run, that images and every
   GI history leaf (the DDGI state's too) repeat bit for bit (a failure
   otherwise); the stats the config makes and no other (no
   draws_phase1 without occlusion, no active_* without the pre-cull), the
   worst frame's binned pairs beside the pair capacity (K1 / K7's
   queues), and K1 80 times on `geo_tex_native` (two phases, the masked
   layer, its peel and the blend bucket a frame) with K5 48 times (the
   resolve and each masked layer's alpha test), K1 16 times on
   `off_no_occlusion`; on `all` the BVH (its builder, which must be the
   native one, its leaves and nodes, the trace route), rt.trace's calls
   (2 a frame: the probe rays and SSR's misses, 32 in all, every one on
   the dense route) and the rays a frame; on `all_ddgi` (2 calls a frame:
   DDGI's update and SSR's misses, dense over the meshlet BVH) and
   `all_exact` (6: RTAO's 4, the probe rays, SSR's misses, all on the
   scan) the same, then one more frame with each rt.trace call timed
   alone (rays, route, scan steps, hit share, ms; RTAO's rays must hit
   somewhere), and on `all_ddgi` every one of the 8,192 probes traced
   after the 16 frames; the second run's DDGI state bit-equal to the
   first's; and per cascade the shadow draws
   (read from the K2 calls) beside what the cull asked for and the pairs
   the bins dropped (none allowed); then the sequence three more times
   (once on `all_exact`) for ms/frame (median and spread). At bench.py's
   shadow_draw_capacity=2048 the far cascade asks for more draws than
   that and drops the rest, as
   chord_tpu does at this config: printed, not failed. The shadow path
   then runs once more at 4096, where every cascade must stay below its
   capacity, and is timed there too. With --profile, each path's device
   busy share and ops per frame, and on the GI paths each GI stage's
   device and host ms (its record_function span; on `all` with the two
   ray spans gi.probe.rt_trace and gi.specular.rt).
6. `repro_eval`: every variant through the tool's run_variant (one call
   at frame 1, three steady), launch counts set to 0 before each variant
   and read after it (K9 1 + 3 times on `tm_pallas`, the sincos kernel
   once a PCSS evaluate with IGN noise, no other kernel), the first
   call's outputs against the same variant on the CPU,
   each variant's steady ms; K9 against its plain version on
   `tm_pallas`'s first call (tolerance 0), timed in turn with x.clone(),
   its library yardstick.
7. `proto_paged_tex`: the tool's main() (K10 1 + 8 times, no other
   kernel); 100% of covered pixels equal to its numpy oracle, every
   untextured pixel -1; K10 against its plain version on main's first
   call (tolerance 0), timed (bound: bytes of u, v, lm, meta, out, cov
   and the 32-B pool sectors the served texels lie in; operations 47 per
   pixel at the f32 rate).
8. A small-input cross-check per frame path but `all_4k` (whose tiny
   config is `all`'s) (tiny atrium, its flat pools on
   `flat`; small textured bistro, with 2 cascades of 256² on the shadow
   paths, and GI on the GI paths, with a BVH of the small scene's
   instances on the ray paths, at each one's granularity): kernels on
   the GPU vs plain versions on
   the CPU (the path the tests hold against chord_tpu), stats exact,
   images within 2 u8 levels; then the same on the tiny `off` scene with
   TSR in each of the tile, gather and global modes, with and without the
   upscale, and with enable_tsr=False and the upscale. The split runs
   the small textured bistro, `interior` build_bistro_interior(detail=1)
   and `nanite` a 3x3 field of 16-ring spheres, on their camera paths.
9. Goldens: the three configs of chord_tpu's golden test
   (tests/test_golden.py:60-87: build_sponza_like(detail=1) at 160x96,
   pair capacity 4096, big capacity 128, draw_capacity=512, no TSR; `basic`
   and `normal` without occlusion, `normal` as the normal debug view,
   `full` with occlusion, ShadowConfig()'s four 1024² cascades and bloom)
   rendered on the card through MeshletRenderer.render, each kernel call
   of the renders held to its plain version (tolerance 0), and each image
   held to tests/goldens/sponza_*_160x96.png with chord_tpu's gates: SSIM
   >= 0.99, mean absolute error < 2 levels, worst 16x16 window SSIM >=
   0.95 (the three numbers printed per image).
10. Debug views: after `all`'s runs, one frame with real history (four
   frames before it, so every cascade holds depth) per debug_mode
   (meshlet, lod, normal, depth, disocclusion, motion, gi, specular,
   shadow) at full size: each image differs from the debug_mode="none"
   frame and its TSR history is finite. Then `meshlet` and `lod` on phase
   8's small `all` scene: the view debug_visualize returns on the third
   frame on the card equals the CPU's bit for bit.
11. Apps: the port's editor in --exec mode (editor.run_script) imports
   assets/demo_street.glb's meshes, builds and saves a .chtp of builtin
   props (the viewer's .chtp library is the builtin meshes, as
   chord_tpu's), adds the street's meshes as nodes and renders the
   viewport at 1920x1080 on the card; then the port's viewer renders
   4 frames at 1920x1080 with --shadows --atmosphere (MeshletRenderer:
   3 cascade warm-up frames first) of the GLB (textured, masked leaf
   cards, gather TSR) and of the saved .chtp (through SceneSubsystem).
   Each run: launch counts set to 0 before it and equal to
   kernels.EXPECTED_LAUNCHES after it, no bin overflow, non-constant
   PNGs, and its last frame's kernel calls held to their plain versions
   (tolerance 0) and timed as in phase 4.

12. Strip-parallel frames (chord_tpu_torch/parallel/sharded.py): two
   ranks share the card (spawn_strips: gloo, NCCL refuses two ranks on
   one GPU), each renders half of the image; each path's host scene is
   built once here and handed to the ranks as numpy. `sharded_all` is
   `all`'s scene, BVH and LUTs rendered natively at 1920x1080 (render =
   post size, as chord_tpu's strip frame needs; tile TSR), two 1920x540
   strips; `sharded_flat` is `flat` in two strips. Per rank: the kernel
   calls of rank 0's fifth frame (every cascade holding depth) held to
   their plain versions (tolerance 0) and timed as in phase 4; the
   16-frame run with launch counts set to 0 before and read after
   (kernels.EXPECTED_LAUNCHES, per rank), no overflow, a finite history,
   the summed stats and the world cache's digest equal on both ranks
   after every frame; three timed runs (the slower rank's ms/frame) beside
   one-process `all` at the same size; each exchange (histogram, world
   cache, stats, image gather) timed alone. Then chord_tpu's tiny
   strips-vs-one-chip configuration (tests/test_sharded.py: under 2% of
   pixels off by more than 8 levels, no strip empty) and the dryrun(2)
   line.
13. Bench goldens (last): phase 5's frames held to
   chord_tpu's own at bench size, tests/goldens/bench/ (rendered on the
   CPU by tests/bench_goldens.py with bench.py's scene, camera path and
   configs, and this script's configs on its own paths; its manifest
   records them): frames 0, 7, 15 of `off` and `flat` (BASELINE #1) and
   frames 0, 7 of `nanite`, `interior`, `geo_tex`, `geo_shadow_atmo`,
   `all`, `all_ddgi`, `geo_tex_native`, `geo_shadow_atmo_split` and
   `off_no_occlusion`, each with chord_tpu's three gates (SSIM >= 0.99,
   MAE < 2, worst 16x16 window >= 0.95). The manifest must exist, come from the
   checkout's chord_tpu sources (sha256) and hold the path's configs
   field for field; each frame's stats are printed beside chord_tpu's and
   held equal to them. Then the ray cell `all_exact_rays` (GOLDEN_RAYS;
   recorded by tests/bench_parity.py `rays`, traced by chord_tpu in
   tests/bench_goldens.py): the triangle BVH phase 5 built for
   `all_exact` must hash as chord_tpu's; on RTAO's four calls and the
   specular call the port's directions, made on the card by gi.rtao and
   meshlet_frame.specular_directions from the recorded G-buffer values
   at the kept pixels, their coordinates and the frame count, must be
   chord_tpu's (its gi.rtao and frame lines on the same inputs) bit for
   bit; and 4,096 rays of each of its frame 0's six rt.trace calls,
   traced on the card over it (the scan at its default budget), must
   give chord_tpu's leaf and t bit for bit on every ray.

Phases 4-5 run per one-process frame path (the split's launches must
equal the inline path's), then 6 to 10, 12, 11 and 13. The line before the last
is the nvidia-smi name/power-limit line, the one before that the
per-kernel JSON (one entry per kernel and path: launches, max_abs_err,
per-frame ms / plain_ms / bound_ms / library_ms summed over the kernel's
calls in one frame, and the per-call detail, with K1, K6, K7, K8 and
K10's work stats and K3 and K9's alternating rounds;
plus each path's ms/frame and the launch floor),
and before that the tools' JSON (each repro variant's first-call seconds
and steady ms, the proto tool's coverage, match and ms, each app run's
seconds, phase 9's and 13's image numbers, the sincos and powf kernels'
checks and times); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import platform
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
# timed reruns of a path's sequence (median and spread); fewer where a
# run takes long: every trace of `all_exact` is the lock-step BVH scan
# (PERF.md §5)
TIMED_RUNS = {"all_exact": 1}
# the flat path: BASELINE config #1 at 1080p on a production-sized Sponza;
# at RendererConfig's pair capacity of 8192 its sub-tile queue runs out of
# rounds (r_cap = capacity // 4) and drops pairs on every frame
FLAT_W, FLAT_H = 1920, 1080
FLAT_DETAIL = 4
FLAT_PAIRS = 16384
# BASELINE config #5, the `all` rung at bench.py --width 3840 --height 2160
# (bench.py:171-186): render 2560x1440, tile TSR to 3840x2160, draw
# capacity 4096, pair capacity 24576, big capacity 128; and the capacities
# at which every frame of its path fits (the path runs again there when
# bench.py's drop anything)
W4, H4, PW4, PH4 = 2560, 1440, 3840, 2160
FULL_4K_CAPS = dict(draw_capacity=8192, masked_draw_capacity=1024,
                    pair_capacity=49152, big_capacity=256)
# bench.py's bistro (bench.py:88-90): every rung renders the textured
# build with its texture pool; `off` turns the texture flags off
BISTRO = dict(detail=3, target_tris=2_600_000, textures=True)
# the paths on a scene with the bench texture pool and masked materials
TEXTURED_PATHS = ("geo_tex", "geo_shadow_atmo", "geo_tex_bricks",
                  "all_no_rt", "all", "all_ddgi", "all_exact",
                  "geo_tex_native", "geo_shadow_atmo_split", "all_4k",
                  "all_cache")
SHADOW_PATHS = ("geo_shadow_atmo", "all_no_rt", "all", "all_ddgi",
                "all_exact", "geo_shadow_atmo_split", "interior", "all_4k",
                "all_cache")
# the bench rung a path renders with another scene or runner: the shadow
# rung with ShadowConfig(pipelined=True) through render_sequence_split,
# and bench.py's `--scene interior` (BASELINE #4, the `all` rung) and
# `--scene nanite` (BASELINE #3, the `off` rung; bench.py:84-95), the
# `all` rung at 4K (BASELINE #5) and with the world-cache GI
RUNG = {"geo_shadow_atmo_split": "geo_shadow_atmo", "interior": "all",
        "nanite": "off", "all_4k": "all", "all_cache": "all"}
SPLIT = "geo_shadow_atmo_split"
# the paths that trace BVH rays, and the granularity of each one's BVH
# (`all` is bench.py's object BVH; the others are built as MeshletRenderer
# builds them: from the path's own instance table, at its granularity)
RAY_PATHS = {"all": "object", "all_ddgi": "meshlet", "all_exact": "triangle",
             "interior": "object", "all_4k": "object", "all_cache": "object"}
# rt.trace calls a frame: the probe rays and SSR's misses; DDGI's update
# and SSR's misses; RTAO's 4 rays, the probe rays and SSR's misses; in
# cache mode SSR's misses alone
TRACES_PER_FRAME = {"all": 2, "all_ddgi": 2, "all_exact": 6, "interior": 2,
                    "all_4k": 2, "all_cache": 1}
# the scene a path's scene is made from (PATHS order builds it first)
SCENE_FROM = {"geo_tex": "off", "geo_shadow_atmo": "geo_tex",
              "geo_tex_bricks": "geo_tex", "all_4k": "all", "all_cache": "all",
              "all_no_rt": "geo_shadow_atmo", "all": "all_no_rt",
              "all_ddgi": "all_no_rt", "all_exact": "all_no_rt",
              "geo_tex_native": "geo_tex", "off_no_occlusion": "off",
              SPLIT: "geo_shadow_atmo"}
# the GI stages' torch.profiler spans (renderer/meshlet_frame.py), named as
# chord_tpu's named_scopes
GI_SPANS = ("gi.ao", "gi.probe.spawn", "gi.probe.sh_reproject",
            "gi.probe.taps", "gi.probe.trace", "gi.probe.project_sh",
            "gi.probe.world_inject", "gi.probe.interpolate",
            "gi.probe.history_reproject", "gi.probe.spatial_filter",
            "gi.probe.upsample", "gi.ddgi.update", "gi.ddgi.sample",
            "gi.inject", "gi.specular", "gi.specular.filter",
            "gi.probe.rt_trace", "gi.specular.rt")
RASTERS = ("raster", "raster_bricks", "raster_subtile")   # K1, K7, K8
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12         # H100 SXM f64 outside the tensor cores
# the kernels whose operations are f64 (the rest count f32)
F64_KERNELS = ("sincos", "powf")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def scene_paths(paths):
    """The paths whose scenes `paths` need, in PATHS order (a path's scene
    is made from SCENE_FROM's)."""
    from chord_tpu_torch.ops.kernels import PATHS

    need = set()
    for p in paths:
        while p is not None:
            need.add(p)
            p = SCENE_FROM.get(p)
    return [p for p in PATHS if p in need]


def bench_scenes(dev, paths):
    """The scene of each path, (pools, instances, views, blend_textured,
    bvh): bench.py's bistro (bench.py:88-100: BISTRO, textured, with its
    pool, for every rung; `off` renders it with the texture flags off) and
    the bench camera path (bench.py:112-131); `geo_tex`, `geo_shadow_atmo`
    and `geo_tex_bricks` reuse `off`'s build, `geo_shadow_atmo` with views
    carrying the host cascade fit and the LUTs (bench.py:236-256),
    `all_no_rt` those views with the env-BRDF LUT, and `all` adds the
    scene BVH (scene_bvh); `all_cache` is `all`'s scene, `all_4k` `all`'s
    with its views at 2560x1440; `flat` is flat_scene(), `interior` and
    `nanite` baseline_scene(). `paths` in PATHS order, each after the path
    its scene comes from."""
    import numpy as np

    from chord_tpu_torch.asset.procedural import build_bistro_like
    from chord_tpu_torch.native import available
    from chord_tpu_torch.renderer import DeviceView
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    if not available():
        raise RuntimeError("the native Nanite builder did not load")
    scenes, textured_bistro = {}, None
    for path in paths:
        t0 = time.time()
        if path == "flat":
            scenes[path] = flat_scene(dev)
            continue
        if path == "all":
            pools, inst, views, blend_tex, _ = scenes[SCENE_FROM[path]]
            scenes[path] = (pools, inst, views, blend_tex,
                            scene_bvh(textured_bistro, pools, dev))
            continue
        if path in ("all_ddgi", "all_exact"):
            pools, inst, views, blend_tex, _ = scenes[SCENE_FROM[path]]
            scenes[path] = (pools, inst, views, blend_tex,
                            path_bvh(path, pools, inst))
            continue
        if path == "all_no_rt":
            pools, inst, views, blend_tex, _ = scenes[SCENE_FROM[path]]
            scenes[path] = (pools, inst,
                            views.replace(brdf_lut=brdf_lut(dev)), blend_tex,
                            None)
            log(f"scene {path}: the geo_shadow_atmo scene and views, with "
                f"the env-BRDF LUT in {time.time() - t0:.2f} s")
            continue
        if path in ("geo_tex", "geo_tex_bricks", "off_no_occlusion", SPLIT,
                    "all_cache"):
            scenes[path] = scenes[SCENE_FROM[path]]
            log(f"scene {path}: the {SCENE_FROM[path]} scene")
            continue
        if path == "all_4k":
            pools, inst, _, blend_tex, bvh = scenes[SCENE_FROM[path]]
            lut = brdf_lut(dev)
            views = [v.replace(brdf_lut=lut) for v in with_luts(
                camera_views(W4, H4, dev, configs(path)[1].shadow_cfg), dev)]
            scenes[path] = (pools, inst, DeviceView.stack(views), blend_tex,
                            bvh)
            log(f"scene {path}: the all scene and BVH, views at {W4}x{H4} "
                f"with the host cascade fit and the LUTs in "
                f"{time.time() - t0:.2f} s")
            continue
        if path in ("interior", "nanite"):
            scenes[path] = baseline_scene(path, dev)
            continue
        if path == "geo_tex_native":
            pools, inst, _, blend_tex, _ = scenes[SCENE_FROM[path]]
            scenes[path] = (pools, inst,
                            DeviceView.stack(camera_views(PW, PH, dev)),
                            blend_tex, None)
            log(f"scene {path}: the geo_tex scene, views at {PW}x{PH}")
            continue
        shadows = path == "geo_shadow_atmo"
        if shadows:     # the bistro of off and geo_tex
            pools, inst, _, blend_tex, _ = scenes[SCENE_FROM[path]]
        else:
            b = build_bistro_like(**BISTRO)
            pools = build_meshlet_pools(b, nanite=True, device=dev,
                                        texture_pool=b.texture_pool)
            n_src = sum(b.meshes[m].num_triangles for m, _, _ in b.instances)
            blend_tex = any(m.alpha_mode == "blend" and
                            m.base_color_texture >= 0 for m in b.materials)
            textured_bistro = b
        mcfg = configs(path)[1]
        cam = Camera(width=W, height=H)
        views = camera_views(W, H, dev, mcfg.shadow_cfg if shadows else None,
                             cam)
        if shadows:
            views = with_luts(views, dev)
            log(f"scene {path}: the geo_tex scene, views with the host "
                f"cascade fit and the atmosphere LUTs in "
                f"{time.time() - t0:.2f} s")
        else:
            inst = b.frame_instances(cam, device=dev)
            rows = 2 if pools.tex_meta.shape[0] == 3 else 8
            log(f"scene {path}: build_bistro_like({BISTRO}), {n_src} "
                f"source tris, {pools.num_meshlets} "
                f"meshlets, {pools.num_pairs} pairs, "
                f"{len(b.materials)} materials, texture pages "
                f"{pools.tex_pages.shape[0] // rows} "
                f"({pools.tex_pages.numel() * 4} B, "
                f"{'compressed' if rows == 2 else 'raw'}), built in "
                f"{time.time() - t0:.2f} s (nanite on)")
        scenes[path] = (pools, inst, DeviceView.stack(views), blend_tex,
                        None)
    return scenes


def place_camera(cam, scene: str, t: float) -> None:
    """bench.py's camera path of `scene` at t in [0, 1] (bench.py:112-131):
    the bistro fly-through, the interior walk toward the window, the
    orbit around the Nanite field."""
    import numpy as np

    if scene == "interior":
        cam.position = np.array([-6.0 + 3.0 * t, 2.2, 3.6 - 1.5 * t])
        cam.look_at(np.array([6.0, 1.2, -2.0]))
    elif scene == "nanite":
        ang = t * 1.5
        cam.position = np.array([50.0 * np.cos(ang), 9.0,
                                 50.0 * np.sin(ang)])
        cam.look_at(np.array([0.0, 2.0, 0.0]))
    else:
        cam.position = np.array([-45.0 + 70.0 * t, 5.0, 4.0])
        cam.look_at(np.array([55.0, 3.0, -4.0]))


def camera_views(w: int, h: int, dev, shadow_cfg=None, cam=None,
                 scene: str = "bistro"):
    """bench.py's camera path of `scene` at w x h -> [DeviceView] (with
    the host cascade fit when `shadow_cfg`); `cam` ends at the path's last
    position."""
    from chord_tpu_torch.renderer import DeviceView
    from chord_tpu_torch.utils.camera import Camera

    cam = cam or Camera(width=w, height=h)
    views = []
    for i in range(FRAMES):
        place_camera(cam, scene, i / (FRAMES - 1))
        views.append(DeviceView.from_uniform(cam.view_uniform(i), device=dev,
                                             shadow_cfg=shadow_cfg))
    return views


def baseline_scene(path, dev):
    """BASELINE #4 or #3 as bench.py builds it at detail 3 (bench.py:
    84-95): `interior` is build_bistro_interior(detail=3) with the `all`
    rung's views (host cascade fit, atmosphere LUTs, env-BRDF LUT) and
    object BVH (scene_bvh); `nanite` is build_nanite_stress(rings=48),
    100 instances of one ~9.2k-triangle sphere whose Nanite cut decides
    what is drawn. Prints the build time, meshlets and pool bytes."""
    from chord_tpu_torch.asset.procedural import (build_bistro_interior,
                                                  build_nanite_stress)
    from chord_tpu_torch.renderer import DeviceView
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    t0 = time.time()
    b = (build_bistro_interior(detail=3) if path == "interior"
         else build_nanite_stress(rings=48))
    pools = build_meshlet_pools(b, nanite=True, device=dev)
    n_src = sum(b.meshes[m].num_triangles for m, _, _ in b.instances)
    pool_bytes = sum(_nbytes(v) for v in vars(pools).values())
    mcfg = configs(path)[1]
    cam = Camera(width=W, height=H)
    views = camera_views(W, H, dev, mcfg.shadow_cfg if mcfg.shadows else None,
                         cam, scene=path)
    what = ("build_bistro_interior(detail=3)" if path == "interior"
            else "build_nanite_stress(rings=48)")
    log(f"scene {path}: {what}, {len(b.instances)} instances, {n_src} "
        f"source tris, {pools.num_meshlets} meshlets, {pools.num_pairs} "
        f"pairs, {len(b.materials)} materials, {pool_bytes} B of pools, built in "
        f"{time.time() - t0:.2f} s (nanite on)")
    bvh = None
    if mcfg.gi:
        lut = brdf_lut(dev)
        views = [v.replace(brdf_lut=lut) for v in with_luts(views, dev)]
        bvh = scene_bvh(b, pools, dev, path)
    return (pools, b.frame_instances(cam, device=dev), DeviceView.stack(views),
            False, bvh)


def scene_bvh(b, pools, dev, path: str = "all"):
    """The `all` rung's BVH as bench.py:221-233 builds it: once, on the
    host, one sphere per valid instance (granularity "object") of
    b.frame_instances(cam) with the camera where bench.py builds it, before
    the camera path moves it (at the origin: translated world is then
    world), by the native builder (fails otherwise); prints the builder,
    leaves, nodes and the route rt.trace takes over them."""
    from chord_tpu_torch.ops import rt
    from chord_tpu_torch.utils.camera import Camera

    t0 = time.time()
    bvh = rt.build_scene_bvh(pools, b.frame_instances(Camera(width=W,
                                                             height=H),
                                                      device=dev),
                             granularity="object")
    leaves = bvh.leaf_sphere.shape[0]
    route = "dense" if leaves <= rt.DENSE_LEAF_LIMIT else "BVH scan"
    log(f"scene {path}: the object BVH "
        f"built by the {rt.build_scene_bvh.builder} builder in "
        f"{time.time() - t0:.2f} s: {leaves} leaves, "
        f"{bvh.node_sphere.shape[0]} nodes, rt.trace route {route} "
        f"(dense up to {rt.DENSE_LEAF_LIMIT} leaves)")
    if rt.build_scene_bvh.builder != "native":
        raise RuntimeError("the scene BVH was not built by the native "
                           "builder")
    return bvh


def path_bvh(path, pools, inst):
    """The BVH of `all_ddgi` or `all_exact`, built as MeshletRenderer.render
    builds it: on the host, from the path's own instance table (the camera
    at the path's last position), at the path's granularity, by the native
    builder (fails otherwise); prints the builder, leaves, nodes and the
    route rt.trace takes over them."""
    from chord_tpu_torch.ops import rt

    t0 = time.time()
    bvh = rt.build_scene_bvh(pools, inst, granularity=RAY_PATHS[path])
    leaves = bvh.leaf_sphere.shape[0]
    limit = (rt.DENSE_TRI_LIMIT if bvh.tri_planes is not None
             else rt.DENSE_LEAF_LIMIT)
    log(f"scene {path}: the all_no_rt scene and views, with the "
        f"{RAY_PATHS[path]} BVH built by the {rt.build_scene_bvh.builder} "
        f"builder in {time.time() - t0:.2f} s: {leaves} leaves, "
        f"{bvh.node_sphere.shape[0]} nodes, rt.trace route "
        f"{'dense' if leaves <= limit else 'BVH scan'} (dense up to "
        f"{limit} leaves)")
    if rt.build_scene_bvh.builder != "native":
        raise RuntimeError("the scene BVH was not built by the native "
                           "builder")
    return bvh


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
    return pools, insts, uniforms, None, None


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
    frame's config and no MeshletFrameConfig; `geo_tex_native` renders
    geo_tex at PWxPH with gather TSR (no upscale) and masked_layers=2,
    `off_no_occlusion` is off without occlusion or pre-cull, with global
    TSR and HDR10; `all_ddgi` is `all` with gi_mode="ddgi" and
    DDGIConfig() over a meshlet BVH, `all_exact` is `all` over a triangle
    BVH with GIConfig(ao_mode="rtao") and the probe march; a RUNG path is
    its rung's (the split with ShadowConfig(pipelined=True), `all_4k` at
    W4xH4 upscaled to PW4xPH4 with bench.py's 4K capacities, `all_cache`
    with gi_mode="cache"). Where bench.py renders the path, the two
    configs are bench.py's field for field (bench.py leaves
    rt_granularity at its default: its BVH is built outside the config)."""
    if path in RUNG:
        config, mcfg = configs(RUNG[path], blend_textured, shadow_cfg,
                               shadow_draws)
        if path == SPLIT:
            mcfg = mcfg._replace(
                shadow_cfg=mcfg.shadow_cfg._replace(pipelined=True))
        if path == "all_4k":
            config = config._replace(width=W4, height=H4, post_width=PW4,
                                     post_height=PH4, pair_capacity=24576,
                                     big_capacity=128)
            mcfg = mcfg._replace(draw_capacity=4096)
        if path == "all_cache":
            mcfg = mcfg._replace(gi_mode="cache")
        return config, mcfg
    from chord_tpu_torch.ops.ddgi import DDGIConfig
    from chord_tpu_torch.ops.gi import GIConfig
    from chord_tpu_torch.ops.kernels import GI_PATHS
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
    if path == "geo_tex_native":
        config = config._replace(width=PW, height=PH, post_width=0,
                                 post_height=0, tsr_mode="gather")
    if path == "off_no_occlusion":
        config = config._replace(tsr_mode="global", output="hdr10")
    tex = path in TEXTURED_PATHS
    occlusion = path != "off_no_occlusion"
    shadows = path in SHADOW_PATHS
    gi = path in GI_PATHS     # bench.py's `all` rung (all_no_rt: no rays)
    exact = path == "all_exact"
    return config, MeshletFrameConfig(
        draw_capacity=2048, masked_draw_capacity=256, occlusion=occlusion,
        object_precull=occlusion, textured=tex, normal_mapped=tex,
        pbr_textures=tex, alpha_masked=tex, alpha_blend=tex,
        blend_textured=blend_textured, shadows=shadows, atmosphere=shadows,
        shadow_masked=shadows, shadow_draw_capacity=shadow_draws,
        shadow_cfg=shadow_cfg or ShadowConfig(), gi=gi,
        gi_mode="ddgi" if path == "all_ddgi" else "probe",
        gi_rt=path in RAY_PATHS, rt_rays=2,
        rt_granularity=("meshlet" if RAY_PATHS.get(path) == "object"
                        else RAY_PATHS.get(path, "meshlet")), ssr=gi,
        trilinear=gi,
        gi_cfg=GIConfig(ao_mode="rtao") if exact else None,
        ddgi_cfg=DDGIConfig() if path == "all_ddgi" else None,
        probe_cfg=ScreenProbeConfig(
            rays=16, steps=6, history_mode="tile",
            trace_mode="march" if exact else "taps"),
        masked_layers=2 if path == "geo_tex_native" else 1)


def history(config, mcfg, dev):
    """A fresh history for the path, as bench.py:259-269 and chord_tpu's
    MeshletRenderer build it (with the cascade cache on the shadow paths
    and the GI state with GI on: the screen probes' in probe mode only,
    DDGI's in ddgi mode)."""
    from chord_tpu_torch.ops.gi import GIConfig
    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    h, w = config.height, config.width
    if mcfg is None:
        return FrameHistory.empty(h, w, device=dev)
    ph, pw = config.post_height, config.post_width
    s = mcfg.shadow_cfg
    if not mcfg.shadows:
        # the (unused) shadow mask at the eval size, as bench.py:259-269
        return FrameHistory.empty(h, w, ph, pw, shadow_div=s.eval_res_div,
                                  device=dev)
    probes = mcfg.gi and mcfg.gi_mode == "probe"
    return FrameHistory.empty(h, w, ph, pw, shadow_div=s.eval_res_div,
                              shadow_cascades=s.cascade_count,
                              shadow_res=s.resolution,
                              shadow_phase=s.temporal_phase,
                              gi_cfg=(mcfg.gi_cfg or GIConfig()) if mcfg.gi
                              else None, probe_tile=8 if probes else 0,
                              ddgi_cfg=mcfg.ddgi_cfg if mcfg.gi else None,
                              device=dev)


def run_path(path, scene, config, mcfg, hist, lo: int = 0,
             hi: Optional[int] = None):
    """Frames lo..hi-1 (default: all) of a path -> (images, history,
    per-frame stats), through the entry points a user calls:
    render_sequence_meshlet (with the scene's BVH on the ray paths),
    render_sequence_split on the split, or DeferredRenderer.render frame
    by frame on `flat`. The r.raster.bricks cvar holds for the run on
    `geo_tex_bricks` and is off otherwise."""
    import torch

    from chord_tpu_torch.renderer import (DeferredRenderer,
                                          render_sequence_meshlet,
                                          render_sequence_split)
    from chord_tpu_torch.utils.cvar import cvars

    from chord_tpu_torch.ops.kernels import run_frames

    pools, inst, views, _, bvh = scene
    hi = run_frames(path) if hi is None else hi
    with cvars.override("r.raster.bricks", path == "geo_tex_bricks"):
        if path != "flat":
            run = (render_sequence_split if path == SPLIT
                   else render_sequence_meshlet)
            return run(pools, inst, frames(views, lo, hi), hist, config,
                       mcfg, bvh=bvh, with_stats=True)
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
    if name == "tile_reproject":
        # per output value the three lerps: 6 products and 3 sums
        return float(args[0].numel()) * 9
    if name == "mesh_shader":
        # per drawn triangle: 3 vertex transforms (28), 3 normal
        # transforms (15) and edge / plane setup (~100)
        count = int(args[2][0])
        return count * 128 * (3 * 28 + 3 * 15 + 100)
    if name == "paged_texture":
        # per textured texel: the shared tap math of its mip and of the
        # fallback mip (20 + 16 over C), its page and fallback ids against
        # the block's two thresholds (4); per texel the palette or the
        # fallback serves (this run's data), the taps' decode and filter
        from chord_tpu_torch.ops import paged_texture

        layers = args[4]
        bilinear = kwargs.get("bilinear", True)
        compressed = args[1].shape[0] == 3
        hit, fb = paged_texture.palette_shares(*args, **kwargs)
        taps = 4 if bilinear else 1
        filt = taps * 4 * (7 if compressed else 0)      # block decode
        filt += 4 * 13 if bilinear else 0               # filter + round
        per = 36 / layers.shape[0] + 4 + (hit + fb) * filt
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
    if name == "sincos":
        # f64, per element of this call's data: below 2^-12 none; below
        # 0.75 x^2 and both polynomials (1 + 8 + 10); above, the reduction
        # (4), the sign and x^2 (2) and both polynomials
        a = args[0].abs()
        return float((a >= 2.0 ** -12).sum()) * 19 + float(
            (a >= 0.75).sum()) * 5
    if name == "powf":
        # f64, per element of this call's data above 2^-126 (below, none):
        # the reduction (4), the log2 polynomial (12), times y (1), the
        # exp2 reduction (4) and cubic (7), the scale (1)
        return float((args[0] >= 2.0 ** -126).sum()) * 29
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


def _reproject_bytes(args, out) -> int:
    """What K4 must move on this call's data: the history pixels (all C
    channels) that its tiles' taps touch, each once, the tile table and
    the output. A tile's output rows read tap rows y0 .. y0 + rows and its
    columns tap columns x0 .. x0 + cols, clamped to the history (the edge
    rule), so each tile touches one rectangle; the union over tiles."""
    import numpy as np

    from chord_tpu_torch.ops.tile_reproject import MARGIN, TILE_H, TILE_W

    img, tab = args
    h, w, c = img.shape
    wt = -(-w // TILE_W)
    touched = np.zeros((h, w), bool)
    for t, (y0p, x0p, _, _) in enumerate(tab.cpu().numpy().tolist()):
        ty, tx = divmod(t, wt)
        rows, cols = min(TILE_H, h - ty * TILE_H), min(TILE_W, w - tx * TILE_W)
        if rows <= 0 or cols <= 0:
            continue
        r0, r1 = np.clip([y0p - MARGIN, y0p - MARGIN + rows], 0, h - 1)
        c0, c1 = np.clip([x0p - MARGIN, x0p - MARGIN + cols], 0, w - 1)
        touched[r0:r1 + 1, c0:c1 + 1] = True
    return int(touched.sum()) * c * 4 + _nbytes(tab) + _nbytes(out)


def bound(name: str, args, kwargs, out, cull: bool = True) -> tuple:
    """-> (bound ms, "bytes" | "operations"); `cull` as in _ops."""
    if name == "pcss":
        n_bytes = _pcss_bytes(args, out)
    elif name == "tile_reproject":
        n_bytes = _reproject_bytes(args, out)
    elif name == "proto_paged_sample":
        n_bytes = _proto_bytes(args, out)
    else:
        n_bytes = (_nbytes(args) + _nbytes(list(kwargs.values())) +
                   _nbytes(out))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = _ops(name, args, kwargs, cull) / (
        F64_OPS_PER_S if name in F64_KERNELS else F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(name: str, args):
    """One PyTorch call computing the same function, where one exists: K3's
    rows are an index_select of the table along the flattened slot; K4 is
    a bilinear grid_sample of the (C,h,w) view of the history with the
    coordinate clamped to the border, which is K4's taps clamped to the
    history (the same values up to the grid's rounding; it writes (1,C,h,w),
    not (h,w,C)); K9 is a clone; the sincos kernel's yardstick is
    PyTorch's own f32 sin and cos (two calls, other roundings). Indices
    and grids are built here, outside the timed call."""
    import torch

    if name == "fusion_barrier":
        return lambda: args[0].clone()
    if name == "sincos":
        return lambda: (torch.sin(args[0]), torch.cos(args[0]))
    if name == "powf":
        return lambda: torch.pow(args[0], args[1])
    if name == "tile_reproject":
        import torch.nn.functional as F

        from chord_tpu_torch.ops.tile_reproject import (FRAC_Q, MARGIN,
                                                        TILE_H, TILE_W)

        img, tab = args
        h, w, _ = img.shape
        y = torch.arange(h, device=img.device)
        x = torch.arange(w, device=img.device)
        t = (y // TILE_H)[:, None] * -(-w // TILE_W) + (x // TILE_W)[None]
        tb = tab.long()[t]                                     # (h,w,4)
        ys = (tb[..., 0] - MARGIN + (y % TILE_H)[:, None]).float() + (
            tb[..., 2].float() / FRAC_Q)
        xs = (tb[..., 1] - MARGIN + (x % TILE_W)[None]).float() + (
            tb[..., 3].float() / FRAC_Q)
        grid = torch.stack([xs * (2.0 / max(w - 1, 1)) - 1.0,
                            ys * (2.0 / max(h - 1, 1)) - 1.0], -1)[None]
        src = img.permute(2, 0, 1)[None]
        return lambda: F.grid_sample(src, grid, mode="bilinear",
                                     padding_mode="border",
                                     align_corners=True)
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


def palette_line(args, kwargs) -> str:
    """K5's palette on a call: the share of textured texels served from
    the palette, from the fallback mip, and by the average colour."""
    from chord_tpu_torch.ops import paged_texture

    if not bool((args[4] >= 0).any()):
        return "no textured texel"
    hit, fb = paged_texture.palette_shares(*args, **kwargs)
    return (f"palette {hit:.4f}, fallback {fb:.4f}, average "
            f"{1 - hit - fb:.4f}")


def palette_report(path, calls) -> dict:
    """Phase 5: K5's palette over a path's run, by channel count ->
    {C: (palette, fallback, average) shares of the textured texels}."""
    from chord_tpu_torch.ops import paged_texture

    sums = {}
    for args, kwargs in calls:
        n = float((args[4] >= 0).sum())
        hit, fb = paged_texture.palette_shares(*args, **kwargs)
        t = sums.setdefault(args[4].shape[0], [0.0, 0.0, 0.0, 0])
        t[0] += n
        t[1] += hit * n
        t[2] += fb * n
        t[3] += 1
    out = {}
    for c, (n, hit, fb, calls_c) in sorted(sums.items()):
        if n == 0:
            log(f"{path}: K5 palette over {calls_c} C={c} calls: no "
                "textured texel")
            continue
        out[c] = (hit / n, fb / n, 1 - (hit + fb) / n)
        log(f"{path}: K5 palette over {calls_c} C={c} calls: palette "
            f"{out[c][0]:.4f}, fallback {out[c][1]:.4f}, average "
            f"{out[c][2]:.4f} of the textured texels")
    return out


def describe(name: str, args, kwargs) -> str:
    if name == "tile_reproject":
        img, tab = args
        return (f"out {'x'.join(map(str, img.shape))} from the history "
                f"{'x'.join(map(str, img.shape))}, {tab.shape[0]} tiles")
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
        return (f"C={c} {mode} {h}x{w} K={kwargs.get('k_pages')}, "
                f"{palette_line(args, kwargs)}, " +
                paged_inputs(args, kwargs))
    if name == "proto_paged_sample":
        pool, _, u = args[:3]
        return (f"{'x'.join(map(str, u.shape))}, pool "
                f"{pool.shape[0] // 8} tiles")
    if name == "fusion_barrier":
        x = args[0]
        return (f"{'x'.join(map(str, x.shape))} {str(x.dtype)[6:]}, "
                f"{x.numel() * x.element_size()} B")
    if name == "sincos":
        x = args[0]
        return (f"{'x'.join(map(str, x.shape))} angles in "
                f"[{float(x.min()):.4g}, {float(x.max()):.4g}]")
    if name == "powf":
        x = args[0]
        return (f"{'x'.join(map(str, x.shape))} ** {args[1]:g}, bases in "
                f"[{float(x.min()):.4g}, {float(x.max()):.4g}], "
                f"{float((x > 0).float().mean()):.3f} above 0")
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


def history_leaves(hist) -> dict:
    """The history's float tensors by name, the DDGI state's as
    `ddgi.<field>`."""
    out = {name: getattr(hist, name) for name in (
        "depth", "tsr_color", "exposure", "hzb_flat", "shadow_mask",
        "shadow_maps", "depth_range", "gi_cache", "probe_sh", "probe_depth",
        "gi_diffuse", "gi_specular")}
    out.update({f"ddgi.{f}": x for f, x in hist.ddgi._asdict().items()})
    return out


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
    for f in range(len(stats["drawn_tris"])):
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
    """The GI state after a run: chord_tpu's shapes; with screen probes,
    probes on geometry that gathered samples; with DDGI, every probe of
    every cascade traced (16 frames update each (cascade, phase) slice
    once) with finite non-negative irradiance that is not all zero; in
    cache mode no probe planes (their 1x1 placeholders, zero); a
    world cache that took probes or surfels (a cascade takes probes only
    where its clipmap holds converged probes), non-negative diffuse and
    specular histories that are not all zero."""
    from chord_tpu_torch.ops.ddgi import probe_count
    from chord_tpu_torch.ops.gi import GIConfig, sh_size

    gcfg = mcfg.gi_cfg or GIConfig()
    h, w = config.height, config.width
    probes = mcfg.gi_mode == "probe"
    ph, pw, hh, hw = ((h // 8, w // 8, h // 2, w // 2) if probes
                      else (1, 1, 1, 1))
    want = {"gi_cache": sh_size(gcfg), "probe_sh": (ph, pw, 28),
            "probe_depth": (ph, pw), "gi_diffuse": (hh, hw, 3),
            "gi_specular": (-(-h // gcfg.sample_res_div),
                            -(-w // gcfg.sample_res_div), 3)}
    if mcfg.gi_mode == "ddgi":
        d = mcfg.ddgi_cfg
        want["ddgi.weight"] = (d.cascades, probe_count(d))
        want["ddgi.irr"] = (d.cascades, probe_count(d), d.irr_side ** 2, 3)
    for name, shape in want.items():
        x = (getattr(hist.ddgi, name[5:]) if name.startswith("ddgi.")
             else getattr(hist, name))
        if tuple(x.shape) != shape:
            raise AssertionError(f"{path}: history {name} is "
                                 f"{tuple(x.shape)}, not {shape}")
    lit = (hist.gi_cache[..., 27] > 0).float().mean(dim=1)
    log(f"{path}: lit cache probes per cascade "
        f"{[round(float(x), 5) for x in lit]}, gi_diffuse in "
        f"[{float(hist.gi_diffuse.min()):.4f}, "
        f"{float(hist.gi_diffuse.max()):.4f}], gi_specular in "
        f"[{float(hist.gi_specular.min()):.4f}, "
        f"{float(hist.gi_specular.max()):.4f}]")
    if probes:
        n = hist.probe_sh[..., 27]
        log(f"{path}: probes with samples {float((n > 0).float().mean()):.4f}"
            f" (median count {float(n.median()):.2f})")
        on_geometry = hist.probe_depth > 0
        if not float((n[on_geometry] > 8).float().mean()) > 0.5:
            raise AssertionError(f"{path}: most probes on geometry hold <= "
                                 "8 samples")
    elif mcfg.gi_mode == "cache":
        planes = {n: float(getattr(hist, n).abs().max())
                  for n in ("probe_sh", "probe_depth", "gi_diffuse")}
        log(f"{path}: world-cache mode, cache rows lit "
            f"{int((hist.gi_cache[..., 27] > 0).sum())} of "
            f"{hist.gi_cache[..., 27].numel()}, probe planes "
            f"{json.dumps(planes)} (max |value|)")
        if any(v != 0.0 for v in planes.values()):
            raise AssertionError(f"{path}: cache mode wrote probe planes")
    else:
        dd = hist.ddgi
        traced = int((dd.weight > 0).sum())
        moved = int((dd.offset.abs().amax(-1) > 0).sum())
        log(f"{path}: DDGI probes traced {traced} of {dd.weight.numel()} "
            f"(weights in [{float(dd.weight.min())}, "
            f"{float(dd.weight.max())}]), relocated {moved}, irradiance in "
            f"[{float(dd.irr.min()):.4f}, {float(dd.irr.max()):.4f}], "
            f"mean distance in [{float(dd.dist[..., 0].min()):.4f}, "
            f"{float(dd.dist[..., 0].max()):.4f}]")
        if traced != dd.weight.numel():
            raise AssertionError(f"{path}: {traced} DDGI probes traced, "
                                 f"not all {dd.weight.numel()}")
        if float(dd.irr.min()) < 0.0 or not float(dd.irr.max()) > 0.0:
            raise AssertionError(f"{path}: DDGI irradiance negative or 0")
    if not bool((lit > 0).any()):
        raise AssertionError(f"{path}: the world cache took nothing")
    for name in ("gi_diffuse", "gi_specular") if probes else ("gi_specular",):
        x = getattr(hist, name)
        if float(x.min()) < 0.0 or not float(x.max()) > 0.0:
            raise AssertionError(f"{path}: history {name} is negative or 0")


def check_rays(path, mcfg, bvh, frames: int) -> None:
    """The BVH rays of a run (rt.trace's counters): TRACES_PER_FRAME calls a
    frame on a ray path, every one on the dense route when the BVH's
    leaves are within its dense limit (the object and meshlet BVHs) and on
    the scan otherwise; on the other paths, none."""
    from chord_tpu_torch.ops import rt

    want = TRACES_PER_FRAME.get(path, 0) * frames
    want_dense = want
    if bvh is not None:
        limit = (rt.DENSE_TRI_LIMIT if bvh.tri_planes is not None
                 else rt.DENSE_LEAF_LIMIT)
        want_dense = want if bvh.leaf_sphere.shape[0] <= limit else 0
    calls, dense = rt.trace.calls, rt.trace.dense
    log(f"{path}: rt.trace called {calls} times, dense route {dense}, BVH "
        f"scan {calls - dense} ({rt.scan_steps} scan steps); "
        f"{calls / frames:.1f} calls and {rt.trace.rays / frames:.0f} rays "
        "a frame")
    if calls != want or dense != want_dense:
        raise AssertionError(f"{path}: rt.trace ran {calls} times ({dense} "
                             f"dense), expected {want} ({want_dense} dense)")


def ray_report(path, scene, hist, config, mcfg, card: str) -> None:
    """One more frame of a ray path with each rt.trace call timed alone
    (synchronised, CUDA events) and its rays' hit share counted: which
    call (RTAO's by its t_max = ao_radius), rays, route, scan steps, ms.
    On `all_exact` RTAO's rays must hit somewhere (share > 0)."""
    import torch

    from chord_tpu_torch.ops import kernels, rt
    from chord_tpu_torch.ops.gi import GIConfig

    orig = rt.trace
    ao_radius = (mcfg.gi_cfg or GIConfig()).ao_radius
    rows = []

    def timed_trace(o, d, bvh, t_max=1e9, max_steps=None):
        torch.cuda.synchronize()
        steps, dense = rt.scan_steps, timed_trace.dense
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t, leaf = orig(o, d, bvh, t_max, max_steps)
        end.record()
        torch.cuda.synchronize()
        rows.append(dict(
            call=("rtao" if t_max == ao_radius else f"t_max {t_max:g}"),
            rays=leaf.numel(), route="dense" if timed_trace.dense > dense
            else "scan", scan_steps=rt.scan_steps - steps,
            hit_share=float((leaf >= 0).float().mean()),
            ms=start.elapsed_time(end)))
        return t, leaf

    # rt.trace counts through its module global, i.e. on the wrapper
    # while patched: carry the counts across
    counters = ("calls", "dense", "rays")
    for c in counters:
        setattr(timed_trace, c, getattr(orig, c))
    rt.trace = timed_trace
    try:
        n = kernels.run_frames(path)
        run_path(path, scene, config, mcfg, hist, n - 1, n)
    finally:
        rt.trace = orig
        for c in counters:
            setattr(orig, c, getattr(timed_trace, c))
    log(f"rt.trace calls of one {path} frame, each timed alone on {card}: "
        + json.dumps(rows))
    ao = [r for r in rows if r["call"] == "rtao"]
    if mcfg.gi_cfg is not None and mcfg.gi_cfg.ao_mode == "rtao":
        share = sum(r["hit_share"] * r["rays"] for r in ao) / max(
            sum(r["rays"] for r in ao), 1)
        log(f"{path}: RTAO rays that hit {share:.5f} "
            f"({len(ao)} calls of {ao[0]['rays'] if ao else 0} rays)")
        if len(ao) != (mcfg.gi_cfg.rtao_rays if mcfg.gi_cfg else 0) or \
                not share > 0.0:
            raise AssertionError(f"{path}: RTAO traced {len(ao)} calls, "
                                 f"hit share {share}")


def main_path(path, scene, card: str,
              shadow_draws: int = BENCH_SHADOW_DRAWS,
              caps: Optional[dict] = None):
    """Phase 5 for one path: the 16-frame sequence (4 on `all_exact`),
    counted, checked and timed, at bench.py's capacities unless
    `shadow_draws` or `caps` (RendererConfig / MeshletFrameConfig fields)
    are given (and then no cascade may reach its capacity and, with
    `caps`, no counter overflow). On `all_4k` at bench.py's capacities an
    overflow is printed, not failed. -> (launches, ms/frame, the
    GOLDEN_FRAMES images and per-frame stats or None, whether a counter
    overflowed)."""
    import torch

    from chord_tpu_torch.ops import kernels, rt

    config, mcfg = configs(path, scene[3], shadow_draws=shadow_draws)
    if caps:
        config = config._replace(**{k: v for k, v in caps.items()
                                    if k in config._fields})
        mcfg = mcfg._replace(**{k: v for k, v in caps.items()
                                if k in mcfg._fields})
    bench = shadow_draws == BENCH_SHADOW_DRAWS and not caps
    label = path if bench else f"{path} at " + ", ".join(
        f"{k} {v}" for k, v in dict(caps or {},
                                    shadow_draw_capacity=shadow_draws).items())
    hist0 = history(config, mcfg, scene[0].positions.device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rt.trace.calls = rt.trace.dense = rt.trace.rays = rt.scan_steps = 0
    t0 = time.time()
    with kernels.capture_inputs() as captured:
        imgs, hist, stats = run_path(path, scene, config, mcfg, hist0)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = kernels.launch_counts()
    n_frames = kernels.run_frames(path)
    check_rays(path, mcfg, scene[4], n_frames)
    worst = {k: int(v.max()) for k, v in stats.items()}
    log(f"{label} path: {n_frames} frames in {first_s:.3f} s (first run), "
        f"worst-frame stats {worst}, launches {launches}")
    if path == "flat":
        log(f"flat path per frame: drawn_tris {stats['drawn_tris'].tolist()}"
            f", binned_pairs {stats['binned_pairs'].tolist()}, "
            f"bin_overflow {stats['bin_overflow'].tolist()} (pair capacity "
            f"{config.pair_capacity})")
    over = {k: v for k, v in worst.items() if "overflow" in k}
    if path == "all_4k":
        log(f"{label}: worst-frame overflow "
            f"{json.dumps(dict(over, max_draws_phase0=worst['draws_phase0']))}"
            f" at draw capacity {mcfg.draw_capacity}, pair capacity "
            f"{config.pair_capacity}, big capacity {config.big_capacity}, "
            f"shadow draw capacity {mcfg.shadow_draw_capacity}")
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        if worst.get(k, 0) != 0 and not (path == "all_4k" and bench):
            raise AssertionError(f"{path}: worst-frame {k} = {worst[k]}")
    if caps and any(over.values()):
        raise AssertionError(f"{label}: overflow {over}")
    if int(stats["drawn_tris"].min()) <= 0:
        raise AssertionError(f"{path}: a frame drew no triangles")
    if mcfg is not None:
        # the audit reads the stats this config makes, and no other
        for k, made in (("draws_phase1", mcfg.occlusion),
                        ("active_overflow", mcfg.object_precull)):
            if (k in stats) != made:
                raise AssertionError(f"{path}: stat {k} "
                                     f"{'missing' if made else 'made'}")
        pairs = [int(args[2].sum()) for name in ("raster", "raster_bricks")
                 for args, _ in captured[name]]
        log(f"{label}: worst binned pairs of a queue {max(pairs)}, pair "
            f"capacity {config.pair_capacity} ({len(pairs)} queues)")
    out_hw = ((config.post_height or config.height,
               config.post_width or config.width) if mcfg
              else (config.height, config.width))
    if tuple(imgs.shape) != (n_frames, *out_hw, 3):
        raise AssertionError(f"{path}: image shape {tuple(imgs.shape)}")
    kept = None
    if path in GOLDEN_FRAMES and bench:
        kept = dict(images={i: imgs[i].cpu().numpy()
                            for i in GOLDEN_FRAMES[path]},
                    stats={k: v.tolist() for k, v in stats.items()})
    last = imgs[-1].float()
    if float(last.std()) < 1.0:
        raise AssertionError(f"{path}: the final image is constant")
    for name, x in history_leaves(hist).items():
        if not bool(torch.isfinite(x).all()):
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
    if captured["paged_texture"]:
        palette_report(label, captured["paged_texture"])
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

    if path in RAY_PATHS:
        ray_report(path, scene, hist, config, mcfg, card)
    times = []
    for i in range(TIMED_RUNS.get(path, 3)):
        torch.cuda.synchronize()
        t0 = time.time()
        again = run_path(path, scene, config, mcfg, hist0)
        torch.cuda.synchronize()
        times.append((time.time() - t0) / n_frames * 1000.0)
        if i == 0 and mcfg is not None and (mcfg.gi or path == SPLIT):
            # the world cache sums probes by scatter-add, DDGI relocates by
            # argmin, the split's service runs as a dispatch of its own:
            # same inputs, same state, run after run?
            keep = (("gi_", "probe_", "ddgi.") if mcfg.gi else ()) + (
                ("shadow_",) if path == SPLIT else ())
            a, b = history_leaves(again[1]), history_leaves(hist)
            diff = {f: float((a[f] - b[f]).abs().max()) for f in a
                    if f.startswith(keep)}
            same = bool(torch.equal(again[0], imgs))
            log(f"{path} run to run: images equal {same}, max |difference| "
                f"of the history {json.dumps(diff)}")
            if not same or any(v != 0.0 for v in diff.values()):
                raise AssertionError(f"{path}: a second run changed the "
                                     "images or the history")
        del again
    ms = statistics.median(times)
    log(f"{label} path: {ms:.3f} ms/frame median of {len(times)} runs "
        f"({', '.join(f'{t:.3f}' for t in times)}; spread "
        f"{max(times) / min(times):.3f}x; {n_frames} frames each, "
        f"synchronize-bounded host clock) on {card}; mean u8 of the last "
        f"frame {float(last.mean()):.3f}")
    return ({k.name: launches[k.name] for k in kernels.KERNELS
             if path in k.paths}, dict(median=ms, runs=times), kept,
            any(v != 0 for v in over.values()))


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
    launched 1 + 3 times by tm_pallas, the sincos kernel once a call of
    it (each PCSS evaluate with IGN noise), no other kernel);
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
        # the PCSS evaluates with IGN noise rotate their disks
        want["sincos"] = len(captured["sincos"])
        if v == "tm_pallas":
            want["fusion_barrier"] = 1 + steady
            k9_calls = {k: calls[:1] for k, calls in captured.items()}
            k9_launches = want
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
    for name, r in rows.items():
        r["launches"] = k9_launches[name]
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


def small_config(path, tsr: Optional[dict] = None):
    """Phase 8's tiny config of a path -> (RendererConfig, frame config):
    render 128x64 (post 192x96 where the path upscales), pair capacity
    4096, big capacity 128, draw capacity 1024, 2 cascades of 256²; `tsr`
    changes the RendererConfig (the TSR variants)."""
    from chord_tpu_torch.ops.shadow import ShadowConfig
    from chord_tpu_torch.renderer import RendererConfig

    if path == "flat":
        return RendererConfig(width=128, height=64, pair_capacity=4096,
                              big_capacity=128, subtiles=True), None
    config, mcfg = configs(path, shadow_cfg=ShadowConfig(cascade_count=2,
                                                         resolution=256))
    up = (192, 96) if config.post_width else (0, 0)
    cfg = config._replace(width=128, height=64, post_width=up[0],
                          post_height=up[1], pair_capacity=4096,
                          big_capacity=128)._replace(**(tsr or {}))
    return cfg, mcfg._replace(draw_capacity=1024)


# phase 8's TSR variants on the tiny `off` scene
TSR_VARIANTS = [dict(tsr_mode=m, post_width=pw, post_height=ph)
                for m in ("tile", "gather", "global")
                for pw, ph in ((192, 96), (0, 0))] + [dict(enable_tsr=False)]


def small_scene(path, d, mcfg, frames: int = 3):
    """Phase 8's tiny scene of a path on `d`: the tiny atrium (its flat
    pools on `flat`) or the small textured bistro, 3 jittered frames, with
    a BVH of its instances at the path's granularity on a ray path."""
    import numpy as np

    from chord_tpu_torch.asset.procedural import (build_bistro_interior,
                                                  build_bistro_like,
                                                  build_nanite_stress,
                                                  build_sponza_like)
    from chord_tpu_torch.ops import rt
    from chord_tpu_torch.renderer import DeviceView
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    if path == "flat":
        return flat_scene(d, detail=1, w=128, h=64, frames=frames,
                          jitter=True)
    tex = path in TEXTURED_PATHS
    if path == "interior":
        b = build_bistro_interior(detail=1)
    elif path == "nanite":
        b = build_nanite_stress(spheres=9, rings=16)
    elif tex:
        b = build_bistro_like(detail=1, textures=True)
    else:
        b = build_sponza_like(detail=1)
    cam = Camera(width=128, height=64)
    vs = []
    for i in range(frames):
        if tex or path in ("interior", "nanite"):
            place_camera(cam, "bistro" if tex else path, i / 15)
        else:
            cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
            cam.look_at(np.array([10.0, 2.0, 0.0]))
        vs.append(DeviceView.from_uniform(
            cam.view_uniform(i, jitter=True), device=d,
            shadow_cfg=mcfg.shadow_cfg if mcfg.shadows else None))
    if mcfg.shadows:
        vs = with_luts(vs, d)
    if mcfg.gi:
        lut = brdf_lut(d)
        vs = [v.replace(brdf_lut=lut) for v in vs]
    pools = build_meshlet_pools(
        b, device=d, texture_pool=getattr(b, "texture_pool", None),
        nanite=path in ("interior", "nanite"))
    inst = b.frame_instances(cam, device=d)
    bvh = (rt.build_scene_bvh(pools, inst, granularity=RAY_PATHS[path])
           if path in RAY_PATHS else None)
    return pools, inst, DeviceView.stack(vs), None, bvh


def small_cross_check(path, dev, tsr: Optional[dict] = None):
    """Phase 8 for one path (with `tsr`, one TSR variant of it): tiny
    inputs, kernels on the GPU vs plain versions on the CPU."""
    import numpy as np
    import torch

    cfg, mcfg = small_config(path, tsr)
    out = {}
    for d in (dev, torch.device("cpu")):
        scene = small_scene(path, d, mcfg)
        imgs, _, st = run_path(path, scene, cfg, mcfg,
                               history(cfg, mcfg, d), 0, 3)
        out[d.type] = (imgs.cpu().numpy().astype(np.int32),
                       {k: v.cpu().tolist() for k, v in st.items()})
    diff = np.abs(out["cuda"][0] - out["cpu"][0])
    frac = float((diff <= 2).mean())
    label = path + (f" {tsr}" if tsr else "")
    log(f"small cross-check {label} (GPU kernels vs CPU plain): stats equal "
        f"{out['cuda'][1] == out['cpu'][1]} {out['cuda'][1]}, max u8 diff "
        f"{int(diff.max())}, within 2 levels {frac}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"stats differ: {out['cuda'][1]} vs "
                             f"{out['cpu'][1]}")
    if frac < 0.999:
        raise AssertionError(f"only {frac} of u8 values within 2 levels")
    if path in TEXTURED_PATHS and max(out["cuda"][1]["draws_masked"]) <= 0:
        raise AssertionError("the small textured scene drew no masked draws")


# --- goldens and debug views -------------------------------------------------

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "goldens")
DEBUG_MODES = ("meshlet", "lod", "normal", "depth", "disocclusion", "motion",
               "gi", "specular", "shadow")


def read_png(path: str):
    """An 8-bit RGB, non-interlaced PNG -> (H,W,3) uint8 numpy array: PIL
    where the machine has it, else zlib and the five row filters here."""
    import struct
    import zlib

    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        return np.asarray(Image.open(path).convert("RGB"))
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = head
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB without interlace")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        up = out[y - 1] if y else np.zeros(3 * w, np.int32)
        if f in (0, 2):
            out[y] = (row + (up if f == 2 else 0)) & 255
            continue
        for x in range(3 * w):     # left-dependent filters, byte by byte
            a = out[y, x - 3] if x >= 3 else 0
            c = up[x - 3] if x >= 3 else 0
            b = up[x]
            if f == 1:
                pred = a
            elif f == 3:
                pred = (a + b) // 2
            else:                  # Paeth
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, x] = (row[x] + pred) & 255
    return out.reshape(h, w, 3).astype(np.uint8)


def ssim(a, b) -> float:
    """Global SSIM of two u8 RGB images on their grey means (chord_tpu's
    tests/test_golden.py:22-33)."""
    import numpy as np

    a = a.astype(np.float64).mean(-1) / 255.0
    b = b.astype(np.float64).mean(-1) / 255.0
    mu_a, mu_b = a.mean(), b.mean()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2)) /
                 ((mu_a ** 2 + mu_b ** 2 + c1) * (a.var() + b.var() + c2)))


def windowed_ssim(a, b, win: int = 16) -> float:
    """The least SSIM over a grid of win x win windows (chord_tpu's
    tests/test_golden.py:36-56)."""
    return worst_window(a, b, win)[0]


def worst_window(a, b, win: int = 16) -> tuple:
    """windowed_ssim's least window -> (SSIM, top row, left column), to
    the bit as chord_tpu's loop computes it. Every window's SSIM is
    first computed at once; only the windows within 1e-9 of the least
    are then computed as the loop does, in its order. On a window equal
    in both images the loop's covariance is its variance, so its SSIM is
    1 exactly unless 2 mu mu and mu**2 + mu**2 round apart."""
    import numpy as np

    ga = a.astype(np.float64).mean(-1) / 255.0
    gb = b.astype(np.float64).mean(-1) / 255.0
    h, w = ga.shape
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ny, nx = (h - win) // win + 1, (w - win) // win + 1
    if ny <= 0 or nx <= 0:
        return (1.0, 0, 0)
    blk = [g[:ny * win, :nx * win].reshape(ny, win, nx, win)
           for g in (ga, gb)]
    mu = [x.mean(axis=(1, 3)) for x in blk]
    cov = ((blk[0] - mu[0][:, None, :, None]) *
           (blk[1] - mu[1][:, None, :, None])).mean(axis=(1, 3))
    s_all = (((2 * mu[0] * mu[1] + c1) * (2 * cov + c2)) /
             ((mu[0] ** 2 + mu[1] ** 2 + c1) *
              (blk[0].var(axis=(1, 3)) + blk[1].var(axis=(1, 3)) + c2)))
    same = (blk[0] == blk[1]).all(axis=(1, 3))
    worst = (1.0, 0, 0)
    for i, j in np.argwhere(s_all <= s_all.min() + 1e-9):
        y, x = int(i) * win, int(j) * win
        wa, wb = ga[y:y + win, x:x + win], gb[y:y + win, x:x + win]
        mu_a = wa.mean()
        if same[i, j]:
            if 2 * mu_a * mu_a == mu_a ** 2 + mu_a ** 2:
                continue                          # SSIM 1 exactly
            mu_b, cov_ab = mu_a, wa.var()
        else:
            mu_b = wb.mean()
            cov_ab = ((wa - mu_a) * (wb - mu_b)).mean()
        s = (((2 * mu_a * mu_b + c1) * (2 * cov_ab + c2)) /
             ((mu_a ** 2 + mu_b ** 2 + c1) * (wa.var() + wb.var() + c2)))
        if float(s) < worst[0]:
            worst = (float(s), y, x)
    return worst


def golden_render(mode: str, dev):
    """chord_tpu's golden config `mode` (tests/test_golden.py:60-87) through
    MeshletRenderer.render on `dev` -> (96,160,3) u8 numpy array."""
    import numpy as np

    from chord_tpu_torch.asset.procedural import build_sponza_like
    from chord_tpu_torch.renderer import (MeshletFrameConfig,
                                          MeshletRenderer, RendererConfig)
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b, device=dev)
    cam = Camera(width=160, height=96)
    cam.position = np.array([-15.0, 4.0, 3.0])
    cam.look_at(np.array([10.0, 2.0, -2.0]))
    r = MeshletRenderer(
        RendererConfig(width=160, height=96, pair_capacity=4096,
                       big_capacity=128, enable_bloom=mode == "full",
                       enable_tsr=False),
        MeshletFrameConfig(draw_capacity=512, occlusion=mode == "full",
                           shadows=mode == "full",
                           debug_mode="normal" if mode == "normal" else
                           "none"))
    img, stats = r.render(pools, b.frame_instances(cam, device=dev),
                          cam.view_uniform(0))
    if int(stats["bin_overflow"]) != 0:
        raise AssertionError(f"golden {mode}: the bins dropped pairs")
    return img.cpu().numpy()


def goldens(dev, card: str) -> dict:
    """Phase 9: the three golden configs on the card, every kernel call of
    the renders against its plain version (tolerance 0), each image held
    to its PNG with chord_tpu's gates -> {mode: numbers}."""
    import numpy as np
    import torch

    from chord_tpu_torch.ops import kernels

    out = {}
    for mode in ("basic", "normal", "full"):
        with kernels.capture_inputs() as captured:
            img = golden_render(mode, dev)
        torch.cuda.synchronize()
        n_calls = 0
        for k in kernels.KERNELS:
            for args, kwargs in captured[k.name]:
                e = kernels.max_abs_err(
                    kernels.outputs_list(k.fn()(*args, **kwargs)),
                    kernels.outputs_list(k.plain(*args, **kwargs)))
                if e != 0.0:
                    raise AssertionError(f"golden {mode}: kernel {k.name} "
                                         f"disagrees with its plain version"
                                         f": {e}")
                n_calls += 1
        golden = read_png(os.path.join(GOLDEN_DIR,
                                       f"sponza_{mode}_160x96.png"))
        if img.shape != golden.shape:
            raise AssertionError(f"golden {mode}: image {img.shape}, PNG "
                                 f"{golden.shape}")
        s, ws = ssim(img, golden), windowed_ssim(img, golden)
        mae = float(np.abs(img.astype(int) - golden.astype(int)).mean())
        calls = {k: len(v) for k, v in captured.items() if v}
        log(f"golden {mode} on {card}: SSIM {s:.6f} (>= 0.99), MAE "
            f"{mae:.4f} (< 2), worst 16x16 window SSIM {ws:.6f} (>= 0.95); "
            f"kernel calls {calls}, all {n_calls} equal to their plain "
            "versions")
        if not (s >= 0.99 and mae < 2.0 and ws >= 0.95):
            raise AssertionError(f"golden {mode} fails its gates")
        out[mode] = dict(ssim=s, mae=mae, worst_window_ssim=ws)
    return out


# phase 13: the frames of phase 5's runs held to chord_tpu's at bench size
# (tests/bench_goldens.py renders them on the CPU into BENCH_GOLDEN_DIR)
BENCH_GOLDEN_DIR = os.path.join(GOLDEN_DIR, "bench")
GOLDEN_FRAMES = {"off": (0, 7, 15), "nanite": (0, 7), "interior": (0, 7),
                 "geo_tex": (0, 7), "geo_shadow_atmo": (0, 7), "all": (0, 7),
                 "flat": (0, 7, 15), "all_ddgi": (0, 7),
                 "geo_tex_native": (0, 7), SPLIT: (0, 7),
                 "off_no_occlusion": (0, 7), "all_4k": (7,),
                 "all_cache": (0, 7), "geo_tex_bricks": (0, 7),
                 "all_no_rt": (0, 7), "sharded_all": (0, 7),
                 "sharded_flat": (0, 7)}


def chord_tpu_hash(root: str) -> str:
    """sha256 over chord_tpu/'s *.py files under `root`: each one's path
    (relative to `root`, sorted) and then its bytes (as
    tests/bench_goldens.py records it)."""
    import hashlib

    files = []
    for d, _, names in os.walk(os.path.join(root, "chord_tpu")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    h = hashlib.sha256()
    for rel in sorted(os.path.relpath(f, root).replace(os.sep, "/")
                      for f in files):
        h.update(rel.encode())
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def config_dict(nt):
    """A config NamedTuple (nested ones too) -> JSON-ready dict, without
    chord_tpu's `interpret` (the port has none)."""
    if hasattr(nt, "_asdict"):
        return {k: config_dict(v) for k, v in nt._asdict().items()
                if k != "interpret"}
    if isinstance(nt, (tuple, list)):
        return [config_dict(v) for v in nt]
    return nt


def image_gates(img, ref) -> dict:
    """SSIM, MAE and the worst 16x16 window (SSIM, where) of two u8
    images."""
    import numpy as np

    if img.shape != ref.shape:
        raise AssertionError(f"image {img.shape}, reference {ref.shape}")
    ws, y, x = worst_window(img, ref)
    return dict(ssim=ssim(img, ref),
                mae=float(np.abs(img.astype(int) - ref.astype(int)).mean()),
                worst_window_ssim=ws, worst_window_at=[y, x])


def bench_manifest() -> dict:
    """The bench goldens' manifest; it must come from the checkout's
    chord_tpu sources."""
    with open(os.path.join(BENCH_GOLDEN_DIR, "manifest.json")) as f:
        man = json.load(f)
    sha = chord_tpu_hash(REPO)
    if man["chord_tpu_sha256"] != sha:
        raise AssertionError(f"the bench goldens were rendered from chord_tpu "
                             f"sources {man['chord_tpu_sha256']}, the "
                             f"checkout's are {sha}")
    return man


def bench_goldens(kept: dict, blend: dict, card: str) -> dict:
    """Phase 13: the GOLDEN_FRAMES of each cell held to chord_tpu's with
    its three gates (SSIM >= 0.99, MAE < 2, worst window >= 0.95); a
    missing PNG or manifest, a manifest made from other chord_tpu sources
    or with another config than the path's, fails (on a strip path,
    phase 12's gathered frames and summed stats: sharded_configs', and
    STRIP_RANKS strips of its strip config). Each frame's stats (those
    both packages make) held equal to chord_tpu's. -> numbers per
    image."""
    man = bench_manifest()
    out = {}
    for path in GOLDEN_FRAMES:
        cell = man["cells"][path]
        strips = path in SHARDED_FROM
        config, mcfg = (sharded_configs if strips else configs)(path,
                                                               blend[path])
        pairs = (("renderer_config", config), ("meshlet_config", mcfg))
        if strips:
            if cell.get("strips") != STRIP_RANKS:
                raise AssertionError(f"bench golden {path}: "
                                     f"{cell.get('strips')} strips, the "
                                     f"path renders {STRIP_RANKS}")
            pairs += (("strip_config", config._replace(
                height=config.height // STRIP_RANKS)),)
        for key, nt in pairs:
            want = json.loads(json.dumps(config_dict(nt)))
            got = cell[key]
            if got != want:
                diff = sorted(k for k in set(got) | set(want)
                              if got.get(k) != want.get(k))
                raise AssertionError(f"bench golden {path}: the manifest's "
                                     f"{key} differs from the path's in "
                                     f"{diff}")
        for i in GOLDEN_FRAMES[path]:
            if str(i) not in cell["images"]:
                raise AssertionError(f"bench golden {path}: no frame {i}")
            ref = read_png(os.path.join(BENCH_GOLDEN_DIR,
                                        cell["images"][str(i)]))
            g = image_gates(kept[path]["images"][i], ref)
            log(f"bench golden {path} frame {i} ({cell['command']}) on "
                f"{card}: SSIM {g['ssim']:.6f} (>= 0.99), MAE "
                f"{g['mae']:.4f} (< 2), worst 16x16 window SSIM "
                f"{g['worst_window_ssim']:.6f} at (row, column) "
                f"{tuple(g['worst_window_at'])} (>= 0.95)")
            if not (g["ssim"] >= 0.99 and g["mae"] < 2.0 and
                    g["worst_window_ssim"] >= 0.95):
                raise AssertionError(f"bench golden {path} frame {i} fails "
                                     "its gates")
            out[f"{path}_f{i:02d}"] = g
        port = kept[path]["stats"]
        ref = cell["stats"]
        n = cell["frames_rendered"]
        keys = sorted(set(port) & set(ref[0]))
        differ = {}
        for k in keys:
            a, b = port[k][:n], [st[k] for st in ref]
            frames_off = [f for f in range(n) if a[f] != b[f]]
            log(f"bench golden {path} stat {k}: port {a}, chord_tpu {b}"
                + (f", differ on frames {frames_off}" if frames_off
                   else ", equal"))
            if frames_off:
                differ[k] = frames_off
        log(f"bench golden {path}: stats only the port makes "
            f"{sorted(set(port) - set(ref[0]))}, only chord_tpu "
            f"{sorted(set(ref[0]) - set(port))}")
        out[f"{path}_stats_differ"] = differ
        if differ:
            raise AssertionError(f"bench golden {path}: stats differ on "
                                 f"{differ}")
    return out


# phase 13's ray cells: a frame path's bench-size traces held ray for ray
# to chord_tpu's (tests/bench_parity.py `rays` records a subset of the rays
# of each rt.trace call of the port's CPU frame 0; tests/bench_goldens.py
# traces them through chord_tpu's own BVH of the same scene): cell -> path
GOLDEN_RAYS = {"all_exact_rays": "all_exact"}
BVH_ARRAYS = ("node_sphere", "node_count", "node_leaf", "tri_planes",
              "leaf_sphere")


def bvh_hashes(bvh) -> dict:
    """{array: {sha256, shape, dtype}} of a SceneBVH's BVH_ARRAYS (either
    package's: tensors on any device, or arrays)."""
    import hashlib

    import numpy as np

    out = {}
    for name in BVH_ARRAYS:
        x = getattr(bvh, name)
        x = np.ascontiguousarray(x.detach().cpu().numpy()
                                 if hasattr(x, "detach") else np.asarray(x))
        out[name] = dict(sha256=hashlib.sha256(x.tobytes()).hexdigest(),
                         shape=list(x.shape), dtype=str(x.dtype))
    return out


def held_directions(data, k: int) -> bool:
    """Whether call k of a ray golden records what its directions are made
    of (RTAO's and the specular GI's calls: a plane size), so the
    directions themselves are held."""
    return int(data["plane"][k][0]) > 0


def ray_directions(name: str, data, k: int, gi_cfg, dev):
    """The port's directions of the kept rays of call k (`name`) of a ray
    golden, made from what the golden recorded: the kept pixels of the
    call's plane (its size `plane`), their G-buffer values and the frame
    count, through the port's own functions on `dev` at the frame's plane
    size (the other pixels zero): RTAO's k-th fan ray of each pixel
    (gi.rtao with `gi_cfg`, rt.trace stubbed) or the specular GI's
    reflection (renderer.meshlet_frame.specular_directions) -> (N,3)."""
    import torch

    from chord_tpu_torch.ops import gi, rt
    from chord_tpu_torch.renderer import meshlet_frame

    h, w = (int(v) for v in data["plane"][k])
    pix = torch.from_numpy(data["pixel"][k].astype("int64")).to(dev)

    def plane(key, c):
        x = torch.zeros((h * w, c), device=dev)
        x[pix] = torch.from_numpy(data[key][k].reshape(-1, c)).to(dev)
        return x.reshape(h, w, c) if c > 1 else x.reshape(h, w)

    fc = torch.tensor(int(data["frame_count"]), dtype=torch.int32,
                      device=dev)
    if name == "specular":
        _, refl = meshlet_frame.specular_directions(
            plane("pos", 3), plane("normal", 3), plane("rough", 1), fc)
        return refl.reshape(-1, 3)[pix]
    dirs, orig = [], rt.trace

    def stub(o, d, bvh, t_max=1e9, max_steps=None):
        dirs.append(d.reshape(-1, 3))
        shape = o.shape[:-1]
        return (torch.full(shape, float(t_max), device=o.device),
                torch.full(shape, -1, dtype=torch.int32, device=o.device))

    rt.trace = stub
    try:
        gi.rtao(plane("pos", 3), plane("normal", 3), None, gi_cfg,
                frame_index=fc)
    finally:
        rt.trace = orig
    return dirs[int(name[len("rtao"):])][pix]


def hold_rays(cell: str, bvh, card: str) -> dict:
    """Phase 13's ray cell `cell`: the BVH of its path (built on the card
    in phase 5, or on the CPU) must hash as chord_tpu's did (BVH_ARRAYS);
    on RTAO's and the specular GI's calls the port's own directions, made
    from the recorded inputs (ray_directions), must be chord_tpu's bit for
    bit on every kept ray; then each call's rays (those directions), traced
    through rt.trace over the BVH (the scan at its default budget), must
    give chord_tpu's leaf and chord_tpu's t to the bit on every ray;
    prints each call's rays, hit share, directions and rays that differ; a
    differing direction, ray or hash fails. -> numbers per call."""
    import numpy as np
    import torch

    from chord_tpu_torch.ops import rt

    man = bench_manifest()
    rec = man["rays"][cell]
    if rec["path"] != GOLDEN_RAYS[cell]:
        raise AssertionError(f"ray golden {cell}: recorded on {rec['path']}")
    got = bvh_hashes(bvh)
    off = sorted(k for k in BVH_ARRAYS if got[k] != rec["bvh"][k])
    shapes = ", ".join(f"{k} {tuple(got[k]['shape'])}" for k in BVH_ARRAYS)
    log(f"ray golden {cell}: the {rec['path']} BVH's arrays ({shapes}) "
        + (f"differ from chord_tpu's in {off}" if off else
           "hash as chord_tpu's"))
    if off:
        raise AssertionError(f"ray golden {cell}: BVH arrays {off} differ "
                             "from chord_tpu's")
    data = np.load(os.path.join(BENCH_GOLDEN_DIR, rec["file"]))
    dev = bvh.node_sphere.device
    gi_cfg = configs(rec["path"])[1].gi_cfg
    out, bad = {}, []
    for k, name in enumerate(data["calls"].tolist()):
        o = torch.from_numpy(data["origins"][k]).to(dev)
        d = torch.from_numpy(data["dirs"][k]).to(dev)
        dir_off = None
        if held_directions(data, k):
            mine = ray_directions(name, data, k, gi_cfg, dev)
            dir_off = int((mine.view(torch.int32) != d.view(torch.int32))
                          .any(-1).sum())
            d = mine
        dense, steps = rt.trace.dense, rt.scan_steps
        t, leaf = rt.trace(o, d, bvh, float(data["t_max"][k]))
        if rt.trace.dense != dense:
            raise AssertionError(f"ray golden {cell} {name}: rt.trace took "
                                 "the dense route")
        t, leaf = t.cpu().numpy(), leaf.cpu().numpy()
        want_t, want_leaf = data["t"][k], data["leaf"][k]
        leaf_off = leaf != want_leaf
        t_off = t.view(np.int32) != want_t.view(np.int32)
        row = dict(rays=int(leaf.size), hit_share=float((leaf >= 0).mean()),
                   chord_tpu_hit_share=float((want_leaf >= 0).mean()),
                   scan_steps=rt.scan_steps - steps,
                   leaf_differ=int(leaf_off.sum()), t_differ=int(t_off.sum()),
                   differ=int((leaf_off | t_off).sum()),
                   direction_differ=dir_off)
        log(f"ray golden {cell} call {name} (t_max {float(data['t_max'][k]):g})"
            f" on {card}: {row['rays']} rays, " +
            ("directions from the recorded inputs that differ from "
             f"chord_tpu's {dir_off}, " if dir_off is not None else
             "directions as recorded, ") +
            f"hit share {row['hit_share']:.5f} (chord_tpu "
            f"{row['chord_tpu_hit_share']:.5f}), {row['scan_steps']} scan "
            f"steps, rays that differ {row['differ']} (leaf "
            f"{row['leaf_differ']}, t bits {row['t_differ']})")
        out[f"{cell}_{name}"] = row
        if row["differ"] or dir_off:
            bad.append(name)
    if bad:
        raise AssertionError(f"ray golden {cell}: rays differ from "
                             f"chord_tpu's on calls {bad}")
    return out


def _caught_views(path, scene, config, mcfg, hist, lo: int, hi: int):
    """Frames lo..hi-1 of a path with debug_visualize's outputs caught ->
    (images, history, [the views])."""
    from chord_tpu_torch.renderer import meshlet_frame as mf

    caught, orig = [], mf.debug_visualize

    def catch(*args, **kwargs):
        caught.append(orig(*args, **kwargs))
        return caught[-1]

    mf.debug_visualize = catch
    try:
        imgs, hist, _ = run_path(path, scene, config, mcfg, hist, lo, hi)
    finally:
        mf.debug_visualize = orig
    return imgs, hist, caught


def debug_views(scene, dev, card: str) -> None:
    """Phase 10: on `all`'s scene at full size, after four frames with
    real history, the fifth frame once per debug_mode: the image must
    differ from the debug_mode="none" frame and its TSR history be finite;
    then `meshlet` and `lod` on phase 8's small `all` scene, the third
    frame's view on the card bit-equal to the CPU's."""
    import torch

    path = "all"
    config, mcfg = configs(path, scene[3])
    hist = run_path(path, scene, config, mcfg,
                    history(config, mcfg, dev), 0, 4)[1]
    none = run_path(path, scene, config, mcfg, hist, 4, 5)[0]
    for mode in DEBUG_MODES:
        img, h2, views = _caught_views(path, scene, config,
                                       mcfg._replace(debug_mode=mode), hist,
                                       4, 5)
        differ = float((img != none).float().mean())
        finite = bool(torch.isfinite(h2.tsr_color).all())
        v = views[0]
        log(f"debug view {mode} on {card}: view {tuple(v.shape)} in "
            f"[{float(v.min()):.4f}, {float(v.max()):.4f}], image values "
            f"differing from the none frame {differ:.4f}, TSR history "
            f"finite {finite}")
        if not differ > 0.0 or not finite or not bool(
                torch.isfinite(v).all()):
            raise AssertionError(f"debug view {mode}: not finite or equal "
                                 "to the none frame")
    cfg, small = small_config(path)
    for mode in ("meshlet", "lod"):
        m = small._replace(debug_mode=mode)
        card_v, cpu_v = (_caught_views(path, small_scene(path, d, m), cfg, m,
                                       history(cfg, m, d), 0, 3)[2][-1].cpu()
                         for d in (dev, torch.device("cpu")))
        same = bool(torch.equal(card_v, cpu_v))
        log(f"debug view {mode}, small {path} scene, third frame: card "
            f"equals CPU bit for bit {same} (values differing "
            f"{float((card_v != cpu_v).float().mean()):.6f})")
        if not same:
            raise AssertionError(f"debug view {mode}: the card and the CPU "
                                 "differ")


# --- the apps ---------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
APP_DIR = os.path.join(REPO, "build", "apps")
GLB = os.path.join(REPO, "assets", "demo_street.glb")
# the GLB's instances (name, library key, translation), laid out by the
# editor as nodes under one parent
STREET = (("ground", "street.1", (0, 0, 0)), ("house_w", "street.0",
          (-10, 5, -2)), ("house_e", "street.0", (9, 5, -3)),
          ("col_a", "street.2", (-6, 0, 4.5)), ("col_b", "street.2",
          (6, 0, 4.5)), ("tree_a", "street.3", (-8, 0, -5)), ("tree_b",
          "street.3", (3, 0, -5)), ("ball", "street.4", (1.5, 1.2, 2)),
          ("sign", "street.5", (-10, 10.8, 1.2)))


def editor_script(chtp: str, full: str, png: str) -> str:
    """The editor's --exec script: import the street GLB's meshes into the
    library, build a scene of builtin props and save it (`chtp`: the
    viewer's .chtp library is the builtin meshes, as chord_tpu's viewer),
    add the street's meshes as nodes, render the viewport at PWxPH and
    save the whole scene (`full`)."""
    cmds = [f"import {GLB} street", "add root props", "sky root",
            "add props floor", "mesh floor builtin.plane", "scale floor 30",
            "add props slab", "mesh slab builtin.box", "move slab 4 0.5 3",
            "add props orb",
            "mesh orb builtin.sphere", "move orb -4 1 3", "add props post",
            "mesh post builtin.cylinder", "move post 0 0 6",
            "mat red 0.8 0.1 0.1", "set slab Mesh.material_key red",
            f"save {chtp}", "add root street"]
    for name, key, (x, y, z) in STREET:
        cmds += [f"add street {name}", f"mesh {name} {key}",
                 f"move {name} {x} {y} {z}"]
    cmds += [f"render {png} {PW} {PH} 14 8 18", f"save {full}", "ls"]
    return "; ".join(cmds)


def app_run(name: str, fn):
    """Run one app invocation with every launch count set to 0 before it
    and every kernel call recorded, each frame's start marked (the
    calls from MeshletRenderer._frame on) -> (fn's result, launches, the
    last frame's calls)."""
    import torch

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.renderer.meshlet_frame import MeshletRenderer

    orig = MeshletRenderer._frame
    marks = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with kernels.capture_inputs() as captured:
        def marked(self, *args, **kwargs):
            marks.append({k: len(v) for k, v in captured.items()})
            return orig(self, *args, **kwargs)

        MeshletRenderer._frame = marked
        try:
            out = fn()
        finally:
            MeshletRenderer._frame = orig
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    last = {k: v[marks[-1][k]:] for k, v in captured.items()}
    log(f"{name}: {len(marks)} frames, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    want = kernels.EXPECTED_LAUNCHES[name]
    if {k: n for k, n in launches.items() if n} != want:
        raise AssertionError(f"{name} launched {launches}, expected {want}")
    return out, launches, last, len(marks)


def check_png(path: str) -> None:
    import numpy as np

    img = read_png(path).astype(np.float32)
    if float(img.std()) < 1.0:
        raise AssertionError(f"{path} is constant")


def apps_phase(dev, card: str):
    """Phase 11: the port's editor in --exec mode imports the street GLB,
    builds and saves a .chtp, renders the street at PWxPH; the viewer
    renders the GLB (textured, masked leaves) and the saved .chtp, 4
    frames each at PWxPH with --shadows --atmosphere, on the card. Each
    run launches the kernels kernels.EXPECTED_LAUNCHES lists and no
    other, overflows nothing, writes non-constant PNGs, and its last
    frame's kernel calls equal their plain versions (tolerance 0, timed
    as phase 4 times them) -> ({app: kernel rows}, summary)."""
    import shutil

    from chord_tpu_torch.apps import editor, viewer

    shutil.rmtree(APP_DIR, ignore_errors=True)
    os.makedirs(APP_DIR)
    chtp = os.path.join(APP_DIR, "props.chtp")
    png = os.path.join(APP_DIR, "editor.png")
    lines = []
    ed = editor.Editor(device=dev)
    ed.out = lines.append
    t0 = time.time()
    _, launches, last, n = app_run("editor", lambda: editor.run_script(
        ed, editor_script(chtp, os.path.join(APP_DIR, "street.chtp"), png)))
    secs = {"editor": time.time() - t0}
    errors = [ln for ln in lines if ln.startswith("error")]
    log(f"editor on {card}: {len(lines)} lines of output in "
        f"{secs['editor']:.2f} s, last: {lines[-12:]}")
    if errors or int(ed.last_stats["bin_overflow"]) != 0:
        raise AssertionError(f"editor: {errors}, bin_overflow "
                             f"{int(ed.last_stats['bin_overflow'])}")
    check_png(png)
    rows = {"editor": (compare_kernels("editor", last, "the render"),
                       launches)}
    for app, scene in (("viewer_glb", GLB), ("viewer_chtp", chtp)):
        out = os.path.join(APP_DIR, app)
        args = viewer.parse_args(["--scene", scene, "--width", str(PW),
                                  "--height", str(PH), "--frames", "4",
                                  "--shadows", "--atmosphere", "--out", out])
        t0 = time.time()
        res, launches, last, n = app_run(app, lambda: viewer.run(args))
        secs[app] = time.time() - t0
        over = [int(st["bin_overflow"]) for st in res["stats"]]
        drawn = [int(st["drawn_tris"]) for st in res["stats"]]
        log(f"{app} on {card}: {n} frames (4 presented) in "
            f"{secs[app]:.2f} s, drawn_tris {drawn}, bin_overflow {over}, "
            f"textured {res['renderer'].mcfg.textured}, masked "
            f"{[int(st.get('draws_masked', 0)) for st in res['stats']]}")
        if any(over) or min(drawn) <= 0:
            raise AssertionError(f"{app}: bin_overflow {over}, drawn {drawn}")
        for i in range(4):
            check_png(os.path.join(out, f"frame_{i:04d}.png"))
        rows[app] = (compare_kernels(app, last, f"frame {n - 1}"), launches)
    return rows, {"seconds": secs}


# --- strip-parallel frames (phase 12) ----------------------------------------

# each sharded path renders its one-process path's frame in strips
SHARDED_FROM = {"sharded_all": "all", "sharded_flat": "flat"}
STRIP_RANKS = 2
STRIP_TIMEOUT_S = 600
LUTS = ("atmo_t_lut", "atmo_ms_lut", "atmo_sky_lut", "brdf_lut")


def sharded_configs(path, blend_textured: bool = False):
    """A sharded path's RendererConfig and MeshletFrameConfig: its
    one-process path's; `all` at its native PWxPH (render = post size: the
    strips' history has no post size, as in chord_tpu), tile TSR."""
    config, mcfg = configs(SHARDED_FROM[path], blend_textured)
    if mcfg is not None:
        config = config._replace(width=PW, height=PH, post_width=0,
                                 post_height=0)
    return config, mcfg


def bistro_uniforms(w: int, h: int):
    """bench.py's bistro camera path at w x h -> [ViewUniform]
    (camera_views' cameras, as host uniforms)."""
    from chord_tpu_torch.utils.camera import Camera

    cam = Camera(width=w, height=h)
    out = []
    for i in range(FRAMES):
        place_camera(cam, "bistro", i / (FRAMES - 1))
        out.append(cam.view_uniform(i))
    return out


def strip_job(path, scenes):
    """A sharded path's StripJob: its host scene, built once in this
    process and handed to the ranks as numpy: on `sharded_all`, `all`'s
    pools, instance table, object BVH and LUTs with the camera path's
    uniforms at PWxPH; on `sharded_flat`, `flat`'s pools, per-frame
    instances and uniforms."""
    from chord_tpu_torch import interop
    from chord_tpu_torch.parallel.sharded import StripJob

    pools, inst, views, blend_tex, bvh = scenes[SHARDED_FROM[path]]
    config, mcfg = sharded_configs(path, blend_tex)
    if path == "sharded_flat":
        return StripJob("flat", config, None, interop.to_numpy(pools),
                        [interop.to_numpy(i) for i in inst], views)
    return StripJob(
        "meshlet", config, mcfg, interop.to_numpy(pools),
        interop.to_numpy(inst), bistro_uniforms(PW, PH),
        bvh=interop.to_numpy(bvh),
        luts={k: getattr(views, k).cpu().numpy() for k in LUTS},
        light_kwargs=dict(shadow_cfg=mcfg.shadow_cfg))



def tiny_strip_job():
    """chord_tpu's strips-vs-one-chip configuration (tests/test_sharded.py:
    build_sponza_like(detail=1) at 128x64, draw_capacity=256,
    occlusion=False, no bloom or TSR), built on the host -> (StripJob,
    RendererConfig, MeshletFrameConfig)."""
    import numpy as np

    from chord_tpu_torch import interop
    from chord_tpu_torch.asset.procedural import build_sponza_like
    from chord_tpu_torch.parallel.sharded import StripJob
    from chord_tpu_torch.renderer import MeshletFrameConfig, RendererConfig
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    b = build_sponza_like(detail=1)
    pools = build_meshlet_pools(b, device="cpu")
    cam = Camera(width=128, height=64)
    cam.position = np.array([-15.0, 4.0, 3.0])
    cam.look_at(np.array([10.0, 2.0, -2.0]))
    inst = b.frame_instances(cam, device="cpu")
    config = RendererConfig(width=128, height=64, pair_capacity=2048,
                            big_capacity=64, enable_bloom=False,
                            enable_tsr=False)
    mcfg = MeshletFrameConfig(draw_capacity=256, occlusion=False)
    u = cam.view_uniform(0)
    return (StripJob("meshlet", config, mcfg, interop.to_numpy(pools),
                     interop.to_numpy(inst), [u]), config, mcfg)


def strip_path_rank(path, rank: int, device, job) -> dict:
    """One rank of a sharded path (phases 4-5 for its strip): frames until
    every cascade holds depth, then one frame whose kernel calls rank 0
    holds to their plain versions and times (compare_kernels); the
    16-frame run with every launch count set to 0 just before and read
    just after (the stats, the world cache's digest after each frame, the
    history's finiteness); three timed runs of 16 frames, each started
    at a barrier."""
    import torch
    import torch.distributed as dist

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.parallel.sharded import (ShardedRenderer, digest,
                                                  load_job)

    t0 = time.time()
    r = ShardedRenderer(job.config, path=job.path, mcfg=job.mcfg,
                        device=device)
    pools, insts, bvh, luts = load_job(job, device)
    kw = job.light_kwargs or {}

    def frame(i):
        return r.render(pools, insts[i], job.uniforms[i], bvh=bvh,
                        luts=luts, **kw)

    m = job.mcfg
    warm = m.shadow_cfg.cascade_count if m is not None and m.shadows else 1
    for i in range(warm):
        frame(i)
    with kernels.capture_inputs() as captured:
        frame(warm)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    rows = (compare_kernels(path, captured, f"frame {warm} of strip 0")
            if rank == 0 else None)
    del captured
    dist.barrier()
    r.reset_history()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    stats, digests, images = [], [], {}
    for i in range(FRAMES):
        img, st = frame(i)
        stats.append({k: v.cpu().tolist() for k, v in st.items()
                      if isinstance(v, torch.Tensor)})
        digests.append(digest(r.history.gi_cache))
        if rank == 0 and i in GOLDEN_FRAMES.get(path, ()):
            images[i] = img.numpy()     # the gathered image, for phase 13
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    first_s = time.time() - t0
    finite = [name for name, x in history_leaves(r.history).items()
              if not bool(torch.isfinite(x).all())]
    last = img.float()
    times = []
    for _ in range(3):
        r.reset_history()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.time()
        for i in range(FRAMES):
            frame(i)
        torch.cuda.synchronize()
        times.append((time.time() - t0) / FRAMES * 1000.0)
    return dict(rows=rows, launches=launches, stats=stats, digests=digests,
                images=images, not_finite=finite, shape=tuple(img.shape),
                std=float(last.std()), mean=float(last.mean()), ms=times,
                setup_s=setup_s, first_s=first_s,
                exchange_ms=strip_exchange_ms(r, img, st))


def strip_exchange_ms(r, image, stats, reps: int = 8) -> dict:
    """Host-clock ms of each exchange a strip frame makes, each run alone
    `reps` times on the last frame's tensors, both ranks started at a
    barrier: the exposure histogram's mean (128 f32), the world cache's
    (GI on), the stats' sum and the image gather."""
    import torch
    import torch.distributed as dist

    from chord_tpu_torch.utils.collectives import all_reduce_mean

    h = r.strip_config.height
    strip = image[r.rank * h:(r.rank + 1) * h]
    parts = {"histogram": lambda: all_reduce_mean(
                 torch.zeros(128, device=r.device), r.group),
             "stats": lambda: r.sum_stats(stats),
             "image": lambda: r.gather(strip)}
    if r.path == "meshlet" and r.mcfg.gi:
        parts["world_cache"] = lambda: all_reduce_mean(r.history.gi_cache,
                                                       r.group)
    out = {}
    for name, fn in parts.items():
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.time() - t0) / reps * 1000.0
    return out


def strip_rank(rank: int, device, jobs: dict) -> dict:
    """A rank of phase 12 (spawn_strips' function): each sharded path's
    job, then the tiny configuration's one frame (its image)."""
    from chord_tpu_torch.parallel.sharded import render_strips

    out = {}
    for name, job in jobs.items():
        out[name] = (render_strips(rank, device, job)[0]["image"]
                     if name == "tiny" else
                     strip_path_rank(name, rank, device, job))
    return out


def native_all_ms(scenes, dev, card: str) -> dict:
    """The one-process `all` frame at the sharded path's config (native
    PWxPH, tile TSR), on `all`'s scene, BVH and LUTs: one warm run, then
    three timed runs of 16 frames -> {median, runs}."""
    import torch

    from chord_tpu_torch.renderer import DeviceView

    config, mcfg = sharded_configs("sharded_all")
    pools, inst, views, blend_tex, bvh = scenes["all"]
    native = DeviceView.stack(camera_views(PW, PH, dev, mcfg.shadow_cfg))
    native = native.replace(**{k: getattr(views, k) for k in LUTS})
    scene = (pools, inst, native, blend_tex, bvh)
    run_path("all", scene, config, mcfg, history(config, mcfg, dev))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        run_path("all", scene, config, mcfg, history(config, mcfg, dev))
        torch.cuda.synchronize()
        times.append((time.time() - t0) / FRAMES * 1000.0)
    log(f"all at {PW}x{PH} in one process (render_sequence_meshlet): "
        f"{statistics.median(times):.3f} ms/frame median of 3 runs "
        f"({', '.join(f'{t:.3f}' for t in times)}) on {card}")
    return dict(median=statistics.median(times), runs=times)


def check_strip_path(path, res) -> None:
    """The ranks' results of one sharded path: per rank every kernel of
    the path launched and no other, kernels.EXPECTED_LAUNCHES, no
    overflow on any frame, triangles drawn, a finite history, a finite
    non-constant whole image of PHxPW (FLAT_HxFLAT_W); the stats and the
    world cache equal on every rank after every frame."""
    from chord_tpu_torch.ops import kernels

    h, w = (PH, PW) if path == "sharded_all" else (FLAT_H, FLAT_W)
    for rank, r in enumerate(res):
        who = f"{path} rank {rank}"
        for k in kernels.KERNELS:
            n = r["launches"][k.name]
            if (path in k.paths) != (n > 0):
                raise AssertionError(f"{who}: kernel {k.name} launched {n} "
                                     "times")
        for name, n in kernels.EXPECTED_LAUNCHES[path].items():
            if r["launches"][name] != n:
                raise AssertionError(f"{who}: {name} launched "
                                     f"{r['launches'][name]} times, expected "
                                     f"{n}")
        for st in r["stats"]:
            for k in ("bin_overflow", "draw_overflow", "active_overflow"):
                if st.get(k, 0) != 0:
                    raise AssertionError(f"{who}: {k} = {st[k]}")
            if st["drawn_tris"] <= 0:
                raise AssertionError(f"{who}: a frame drew no triangles")
        if r["not_finite"]:
            raise AssertionError(f"{who}: history {r['not_finite']} not "
                                 "finite")
        if r["shape"] != (h, w, 3) or not r["std"] >= 1.0:
            raise AssertionError(f"{who}: image {r['shape']}, std "
                                 f"{r['std']}")
        if r["stats"] != res[0]["stats"]:
            raise AssertionError(f"{who}: the summed stats differ from "
                                 "rank 0's")
    for i, ds in enumerate(zip(*(r["digests"] for r in res))):
        if len(set(ds)) != 1:
            raise AssertionError(f"{path} frame {i}: the ranks' world "
                                 "caches differ")
    if path == "sharded_all" and max(st["draws_masked"]
                                     for st in res[0]["stats"]) <= 0:
        raise AssertionError(f"{path}: no masked draws on any frame")


def sharded_phase(scenes, dev, card: str):
    """Phase 12: the strip-parallel frames, two ranks on the one card
    (spawn_strips: gloo, the ranks share the card), each path's host
    scene handed to the ranks as numpy; rank 0's kernel calls held to
    their plain versions, each rank's launches, overflows and history
    checked, the world cache equal on both ranks after every frame
    (check_strip_path), ms/frame beside the one-process `all` at the same
    size; chord_tpu's tiny strips-vs-one-chip configuration under its 2%
    gate; the dryrun(2) line -> (kernel rows, {path: ms/frame}, {path:
    rank 0's GOLDEN_FRAMES images and per-frame summed stats}, for phase
    13)."""
    import numpy as np

    from chord_tpu_torch import interop
    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.parallel.sharded import dryrun, spawn_strips
    from chord_tpu_torch.renderer import MeshletRenderer

    t0 = time.time()
    jobs = {p: strip_job(p, scenes) for p in kernels.SHARDED}
    tiny, tiny_cfg, tiny_mcfg = tiny_strip_job()
    jobs["tiny"] = tiny
    ms = {"all one process": native_all_ms(scenes, dev, card)}
    log(f"phase 12: the strip jobs' host scenes in "
        f"{time.time() - t0:.2f} s; {STRIP_RANKS} ranks")
    t0 = time.time()
    ranks = spawn_strips(STRIP_RANKS, strip_rank, jobs,
                         timeout_s=STRIP_TIMEOUT_S)
    log(f"phase 12: the ranks ran in {time.time() - t0:.2f} s")
    rows, kept = [], {}
    for path in kernels.SHARDED:
        res = [r[path] for r in ranks]
        check_strip_path(path, res)
        kept[path] = dict(images=res[0]["images"],
                          stats={k: [st[k] for st in res[0]["stats"]]
                                 for k in res[0]["stats"][0]})
        runs = [max(t) for t in zip(*(r["ms"] for r in res))]
        ms[path] = dict(median=statistics.median(runs), runs=runs,
                        per_rank=[r["ms"] for r in res])
        worst = {k: max(st[k] for st in res[0]["stats"])
                 for k in res[0]["stats"][0]}
        log(f"{path}: {STRIP_RANKS} strips of {res[0]['shape'][0] // STRIP_RANKS}"
            f" rows, launches per rank {[r['launches'] for r in res]}, "
            f"worst-frame summed stats {worst}, "
            f"{'world caches equal on every frame, ' if path == 'sharded_all' else ''}"
            f"first run {res[0]['first_s']:.3f} s, set-up "
            f"{res[0]['setup_s']:.2f} s; {ms[path]['median']:.3f} ms/frame "
            f"median of 3 runs ({', '.join(f'{t:.3f}' for t in runs)}; the "
            f"slower rank's), mean u8 {res[0]['mean']:.3f} on {card}; "
            f"exchanges alone, ms a frame per rank: "
            f"{[r['exchange_ms'] for r in res]}")
        ms[path]["exchange_ms"] = [r["exchange_ms"] for r in res]
        for name, row in res[0]["rows"].items():
            row["launches"] = res[0]["launches"][name]
            rows.append(row)
    log(f"sharded_all {ms['sharded_all']['median']:.3f} ms/frame against "
        f"all in one process {ms['all one process']['median']:.3f} at "
        f"{PW}x{PH} on {card}")
    # chord_tpu's gate (tests/test_sharded.py): under 2% of pixels off by
    # more than 8 levels, no strip empty
    single = MeshletRenderer(tiny_cfg, tiny_mcfg)
    one, _ = single.render(interop.pools_from_numpy(tiny.pools, dev),
                           interop.instances_from_numpy(tiny.instances, dev),
                           tiny.uniforms[0])
    one = one.cpu().numpy().astype(np.int32)
    img = ranks[0]["tiny"].astype(np.int32)
    off = float((np.abs(one - img).max(-1) > 8).mean())
    stds = [float(img[k * 32:(k + 1) * 32].std()) for k in range(2)]
    log(f"tiny strips vs one process on {card}: {off:.4f} of pixels off by "
        f"more than 8 levels (gate 0.02), strip std {stds}")
    if off >= 0.02 or min(stds) <= 1.0:
        raise AssertionError("the tiny sharded frame fails chord_tpu's gate")
    dryrun(STRIP_RANKS)
    return rows, ms, kept


def ptxas_lines(sources=("pcss.cu", "proto_paged_tex.cu",
                         "paged_texture.cu")) -> None:
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



def paged_edge_cases(dev) -> None:
    """K5 on the page-id edge cases of tests/paged_palette_cases.py (ids
    at or above n_pages and below 0, exactly K and K + 1 distinct ids in a
    block, a pool wider than the kernel's bitmap, untextured and partial
    blocks, a huge mip), bilinear and nearest: output and coverage
    bit-equal to the plain version, or the run fails."""
    import torch

    from chord_tpu_torch.ops import paged_texture

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from paged_palette_cases import EDGE_CASES, edge_case

    for name in sorted(EDGE_CASES):
        case = edge_case(name)
        args = [torch.from_numpy(case[k]) for k in ("pages", "meta")] + [
            case["n_mips"], case["mip_sizes"]] + [
            torch.from_numpy(case[k]) for k in ("layers", "uv", "mip")]
        on_dev = [a.to(dev) if isinstance(a, torch.Tensor) else a
                  for a in args]
        for bilinear in (True, False):
            kw = dict(bilinear=bilinear, block_h=16,
                      k_pages=case["k_pages"], with_coverage=True)
            got = paged_texture.paged_sample(*on_dev, **kw)
            ref = paged_texture.paged_sample_plain(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)):
                raise AssertionError(f"K5 disagrees with its plain version "
                                     f"on edge case {name}, bilinear "
                                     f"{bilinear}")
    log(f"K5 on {len(EDGE_CASES)} page-id edge cases "
        f"({', '.join(sorted(EDGE_CASES))}), bilinear and nearest: output "
        "and coverage equal to the plain version (tolerance 0)")

# the sincos kernel's exhaustive hold: f32 bit patterns a chunk; the
# seeded inputs held to this host's C library; the plane it is timed at
SINCOS_CHUNK = 1 << 25
SINCOS_LIBM = 1_000_000
SINCOS_PLANE = (720, 1280)


def sincos_checks(dev, card: str) -> dict:
    """The sincos kernel (csrc/sincos.cu, chord_tpu's XLA f32 sin and cos
    on the card): bit for bit its plain version on every f32 in (-120, 120)
    (every bit pattern below 120.0f's, both signs, in chunks: the fast
    reduction's whole range; a difference fails); SINCOS_LIBM seeded inputs
    of every range against the plain version (a difference fails) and
    against this host's C library sinf / cosf (counted and printed beside
    the library's version: the goldens' trig is the C library of the host
    that rendered them, which the plain version transcribes); then timed
    at a SINCOS_PLANE plane of angles in RTAO's range in turns with
    torch.sin + torch.cos -> numbers."""
    import numpy as np
    import torch

    from chord_tpu_torch.ops import _util

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from rt_cases import libm_sincosf

    t0 = time.time()
    top, n, bad = 0x42F00000, 0, 0        # 120.0f's bits
    for lo in range(0, top, SINCOS_CHUNK):
        bits = torch.arange(lo, min(lo + SINCOS_CHUNK, top),
                            dtype=torch.int32, device=dev)
        for sign in (0, -2 ** 31):
            x = (bits | sign).view(torch.float32)
            got, ref = _util.sincos_cuda(x), _util.sincosf_plain(x)
            for g, r in zip(got, ref):
                bad += int((g.view(torch.int32) != r.view(torch.int32)).sum())
            n += x.numel()
    torch.cuda.synchronize()
    log(f"sincos kernel on every f32 in (-120, 120) ({n} values, chunks of "
        f"{SINCOS_CHUNK}) on {card}: {bad} sin or cos bits differ from its "
        f"plain version, in {time.time() - t0:.1f} s")
    if bad:
        raise AssertionError(f"sincos kernel: {bad} values differ from its "
                             "plain version in (-120, 120)")
    rng = np.random.default_rng(22)
    k = SINCOS_LIBM // 4
    x = np.concatenate([
        rng.uniform(-30, 30, k), rng.uniform(-1, 1, k),
        rng.uniform(-1e5, 1e5, k),
        10 ** rng.uniform(-30, 38, SINCOS_LIBM - 3 * k) *
        rng.choice([-1.0, 1.0], SINCOS_LIBM - 3 * k)]).astype(np.float32)
    got = [g.cpu().numpy() for g in _util.sincos_cuda(
        torch.from_numpy(x).to(dev))]
    ref = [r.numpy() for r in _util.sincosf_plain(torch.from_numpy(x))]
    plain_off = sum(int((g.view(np.int32) != r.view(np.int32)).sum())
                    for g, r in zip(got, ref))
    libm = libm_sincosf(x)
    libm_off = sum(int((g.view(np.int32) != r.view(np.int32)).sum())
                   for g, r in zip(got, libm))
    libc = " ".join(platform.libc_ver())
    log(f"sincos kernel on {x.size} seeded inputs (seed 22; |x| up to "
        f"1e38): {plain_off} sin or cos values differ from the plain "
        f"version on the CPU, {libm_off} from this host's C library "
        f"({libc}) sinf / cosf")
    if plain_off:
        raise AssertionError(f"sincos kernel: {plain_off} seeded values "
                             "differ from the plain version")
    ang = torch.from_numpy(rng.uniform(
        0.0, 2.0 * np.pi + 3.5 * 2.4, SINCOS_PLANE).astype(np.float32)).to(
        dev)
    kern = lambda: _util.sincos_cuda(ang)
    lib = lambda: (torch.sin(ang), torch.cos(ang))
    runs = alternate([kern, lib])
    ms, lib_ms = (statistics.median(r) for r in runs)
    log(f"sincos kernel at {SINCOS_PLANE[1]}x{SINCOS_PLANE[0]} angles in "
        f"[0, 2 pi + 8.4) on {card}: {spread(runs[0])} vs torch.sin + "
        f"torch.cos {spread(runs[1])}, medians of {len(runs[0])} "
        "alternating rounds of 200 calls")
    return dict(exhaustive_values=n, exhaustive_differ=bad,
                seeded=int(x.size), seeded_differ_plain=plain_off,
                seeded_differ_libm=libm_off, libc=libc,
                plane=list(SINCOS_PLANE), ms=ms, torch_sin_cos_ms=lib_ms,
                ms_rounds=runs[0], torch_sin_cos_ms_rounds=runs[1])


# the powf kernel's exhaustive hold: bases a chunk; the seeded inputs; the
# weight planes it is timed at (the firefly clamp's eight at 1280x720)
POWF_CHUNK = 1 << 25
POWF_SEEDED = 1_000_000
POWF_PLANES = (8, 90, 160)


def powf_checks(dev, card: str) -> dict:
    """The powf kernel (csrc/powf.cu, chord_tpu's XLA f32 power on the
    card): bit for bit its plain version on every f32 in [2^-126, 1] with
    y = 8, the edge weight's exponent (in chunks; a difference fails);
    POWF_SEEDED seeded inputs of several ranges and exponents against the
    plain version (a difference fails) and against this host's C library
    powf with XLA's flush to zero (counted and printed); then timed at
    POWF_PLANES weight bases in turns with torch.pow -> numbers."""
    import numpy as np
    import torch

    from chord_tpu_torch.ops import _util

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from rt_cases import libm_powf

    t0 = time.time()
    lo, hi, n, bad = 0x00800000, 0x3F800001, 0, 0
    for a in range(lo, hi, POWF_CHUNK):
        x = torch.arange(a, min(a + POWF_CHUNK, hi), dtype=torch.int32,
                         device=dev).view(torch.float32)
        got, ref = _util.powf_cuda(x, 8.0), _util.powf_plain(x, 8.0)
        bad += int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        n += x.numel()
    torch.cuda.synchronize()
    log(f"powf kernel on every f32 in [2^-126, 1] with y = 8 ({n} values, "
        f"chunks of {POWF_CHUNK}) on {card}: {bad} differ from its plain "
        f"version, in {time.time() - t0:.1f} s")
    if bad:
        raise AssertionError(f"powf kernel: {bad} values differ from its "
                             "plain version in [2^-126, 1]")
    rng = np.random.default_rng(23)
    k = POWF_SEEDED // 4
    x = np.concatenate([rng.random(k), rng.random(k) ** 30,
                        rng.uniform(1, 100, k),
                        rng.random(POWF_SEEDED - 3 * k)]).astype(np.float32)
    plain_off = libm_off = 0
    for y in (8.0, 0.5, 2.5, 16.0):
        got = _util.powf_cuda(torch.from_numpy(x).to(dev), y).cpu().numpy()
        ref = _util.powf_plain(torch.from_numpy(x), y).numpy()
        plain_off += int((got.view(np.int32) != ref.view(np.int32)).sum())
        libm_off += int((got.view(np.int32) != libm_powf(x, y).view(
            np.int32)).sum())
    libc = " ".join(platform.libc_ver())
    log(f"powf kernel on {x.size} seeded inputs x 4 exponents (seed 23): "
        f"{plain_off} values differ from the plain version on the CPU, "
        f"{libm_off} from this host's C library ({libc}) powf, flushed to "
        "zero as XLA")
    if plain_off:
        raise AssertionError(f"powf kernel: {plain_off} seeded values "
                             "differ from the plain version")
    base = torch.from_numpy(rng.random(POWF_PLANES).astype(
        np.float32)).to(dev)
    runs = alternate([lambda: _util.powf_cuda(base, 8.0),
                      lambda: torch.pow(base, 8.0)])
    ms, lib_ms = (statistics.median(r) for r in runs)
    log(f"powf kernel at {'x'.join(map(str, POWF_PLANES))} bases on "
        f"{card}: {spread(runs[0])} vs torch.pow {spread(runs[1])}, "
        f"medians of {len(runs[0])} alternating rounds of 200 calls")
    return dict(exhaustive_values=n, exhaustive_differ=bad,
                seeded=int(x.size) * 4, seeded_differ_plain=plain_off,
                seeded_differ_libm=libm_off, libc=libc,
                planes=list(POWF_PLANES), ms=ms, torch_pow_ms=lib_ms,
                ms_rounds=runs[0], torch_pow_ms_rounds=runs[1])


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
    from chord_tpu_torch.ops.kernels import FRAME_PATHS, TOOL_PATHS

    smi = card_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, C library "
        f"{' '.join(platform.libc_ver())}")

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
    paged_edge_cases(dev)
    sincos = sincos_checks(dev, smi)
    powf = powf_checks(dev, smi)

    scenes = bench_scenes(dev, FRAME_PATHS)
    rows, ms_per_frame, path_launches, kept = [], {}, {}, {}
    for p in FRAME_PATHS:
        t0 = time.time()
        krows = check_kernels(p, scenes[p])
        launches, ms_per_frame[p], kept[p], over = main_path(p, scenes[p],
                                                             smi)
        path_launches[p] = launches
        if p == "geo_shadow_atmo":
            ms_per_frame[f"{p} shadow_draw_capacity {FULL_SHADOW_DRAWS}"] = \
                main_path(p, scenes[p], smi, FULL_SHADOW_DRAWS)[1]
        if p == "all_4k" and over:
            ms_per_frame[f"{p} {json.dumps(FULL_4K_CAPS)} shadow_draw_"
                         f"capacity {FULL_SHADOW_DRAWS}"] = main_path(
                p, scenes[p], smi, FULL_SHADOW_DRAWS, FULL_4K_CAPS)[1]
        for name, n in launches.items():
            krows[name]["launches"] = n
        rows += list(krows.values())
        log(f"{p}: phases 4-5 in {time.time() - t0:.1f} s")
        if "--profile" in sys.argv[1:]:
            profile(p, scenes[p])
    # the split launches what the inline path launches: the service
    # refreshes one cascade and evaluates PCSS once a frame
    if path_launches[SPLIT] != path_launches["geo_shadow_atmo"]:
        raise AssertionError(f"{SPLIT} launched {path_launches[SPLIT]}, the "
                             f"inline path {path_launches['geo_shadow_atmo']}")
    # phase 13's ray cells trace over the BVHs phase 5 built
    ray_bvhs = {c: scenes[p][4] for c, p in GOLDEN_RAYS.items()}
    blend = {p: scenes[p][3] for p in kept}
    blend.update({p: scenes[src][3] for p, src in SHARDED_FROM.items()})
    tool_phase = {"repro_eval": lambda: repro_eval_path(dev, smi),
                  "proto_paged_tex": lambda: proto_paged_tex_path(smi)}
    tools = {}
    for p in TOOL_PATHS:
        krows, tools[p] = tool_phase[p]()
        rows += list(krows.values())
    t0 = time.time()
    for p in FRAME_PATHS:
        if p != "all_4k":     # its tiny config is `all`'s
            small_cross_check(p, dev)
    for tsr in TSR_VARIANTS:
        small_cross_check("off", dev, tsr)
    log(f"phase 8 in {time.time() - t0:.1f} s")
    golden = goldens(dev, smi)
    debug_views(scenes["all"], dev, smi)
    strip_rows, strip_ms, strip_kept = sharded_phase(scenes, dev, smi)
    rows += strip_rows
    ms_per_frame.update(strip_ms)
    kept.update(strip_kept)
    del scenes
    app_rows, apps = apps_phase(dev, smi)
    for krows, launches in app_rows.values():
        for name, r in krows.items():
            r["launches"] = launches[name]
        rows += list(krows.values())
    t0 = time.time()
    bench_golden = bench_goldens(kept, blend, smi)
    for c, bvh in ray_bvhs.items():
        bench_golden.update(hold_rays(c, bvh, smi))
    del ray_bvhs
    log(f"phase 13 in {time.time() - t0:.1f} s")
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"tools": tools, "goldens": golden,
                      "bench_goldens": bench_golden, "apps": apps,
                      "sincos": sincos, "powf": powf}))

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
