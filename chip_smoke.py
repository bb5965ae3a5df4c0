#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (chord_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the default run
    python3 chip_smoke.py --profile    # + a torch.profiler breakdown per path

Two paths, the bench's `off` and `geo_tex` rungs (bench.py:35-54): the
1280x720 render of the 2.6M-triangle procedural bistro (Nanite LOD cut),
upscaled to 1920x1080 by tile-mode TSR, bloom and the ACES tonemap;
`geo_tex` adds the bench texture pool (12 layers of 256², block-compressed
pages), base / normal / metal-rough maps, the alpha-masked bucket and the
blend bucket, on the bistro built with textures=True.

Phases (any failure raises and the script exits non-zero):

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the five hand-written kernels (chord_tpu_torch/csrc/*.cu, one
   nvcc per source, all at once) into build/kernels/.
3. Builds both scenes (sharing the Nanite DAG of their common meshes) and
   prints build time, page count and pool bytes.
4. Kernel vs plain version, per path: runs two frames of the path while
   recording every kernel call's inputs, then runs each kernel and its
   plain PyTorch version on the second frame's calls (K1 raster, K2 mesh
   shader, K3 row gather, K4 tile reproject on both paths; K5 paged
   texture sampler on `geo_tex`, both its calls: 4 maps bilinear and 1 map
   nearest). Tolerance 0: the kernels are built with -fmad=false and round
   every operation as the plain versions do. Times each call (CUDA
   events, inputs L2-warm), computes its bound (the larger of the bytes
   its inputs and outputs occupy over 3.35 TB/s and the f32 operations
   this run's data needs over 67 TFLOP/s) and, for K3, times one
   torch.index_select of the same rows as a library yardstick.
5. Each path's 16-frame sequence, render_sequence_meshlet(with_stats=True),
   with every launch count set to 0 just before and read just after:
   worst-frame overflows 0, drawn triangles > 0, a finite non-constant
   image, every kernel of the path launched (K5 32 times on `geo_tex`,
   with masked draws on some frame); then the sequence again for ms/frame.
6. A small-input cross-check per path (tiny atrium; small textured
   bistro): kernels on the GPU vs plain versions on the CPU (the path the
   tests hold against chord_tpu), stats exact, images within 2 u8 levels.

The line before the last is the nvidia-smi name/power-limit line, the one
before that the per-kernel JSON (one entry per kernel and path: launches,
max_abs_err, per-frame ms / plain_ms / bound_ms / library_ms summed over
the kernel's calls in one frame, and the per-call detail; plus each
path's ms/frame); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

W, H, PW, PH = 1280, 720, 1920, 1080
FRAMES = 16
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
    """The bench bistro of each path (bench.py:88-100; textures off for
    `off`, on for `geo_tex`) and the bench camera path
    (bench.py:112-131)."""
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
        textured = path == "geo_tex"
        b = build_bistro_like(detail=3, target_tris=2_600_000,
                              textures=textured)
        pools = build_meshlet_pools(
            b, meshlet_cache=cache, nanite=True, device=dev,
            texture_pool=b.texture_pool if textured else None)
        n_src = sum(b.meshes[m].num_triangles for m, _, _ in b.instances)
        cam = Camera(width=W, height=H)
        views = []
        for i in range(FRAMES):
            t = i / (FRAMES - 1)
            cam.position = np.array([-45.0 + 70.0 * t, 5.0, 4.0])
            cam.look_at(np.array([55.0, 3.0, -4.0]))
            views.append(DeviceView.from_uniform(cam.view_uniform(i),
                                                 device=dev))
        inst = b.frame_instances(cam, device=dev)
        rows = 2 if pools.tex_meta.shape[0] == 3 else 8
        log(f"scene {path}: {n_src} source tris, {pools.num_meshlets} "
            f"meshlets, {pools.num_pairs} pairs, "
            f"{len(b.materials)} materials, texture pages "
            f"{pools.tex_pages.shape[0] // rows} "
            f"({pools.tex_pages.numel() * 4} B, "
            f"{'compressed' if rows == 2 else 'raw'}), built in "
            f"{time.time() - t0:.2f} s (nanite on)")
        blend_tex = any(m.alpha_mode == "blend" and m.base_color_texture >= 0
                        for m in b.materials)
        scenes[path] = (pools, inst, DeviceView.stack(views), blend_tex)
    return scenes


def configs(path: str, blend_textured: bool = False):
    """bench.py's RendererConfig and MeshletFrameConfig for a rung
    (bench.py:171-219 at render scale 0.6667)."""
    from chord_tpu_torch.renderer import MeshletFrameConfig, RendererConfig

    config = RendererConfig(width=W, height=H, post_width=PW, post_height=PH,
                            pair_capacity=8192, big_capacity=64,
                            enable_bloom=True, enable_tsr=True,
                            tsr_mode="tile")
    tex = path == "geo_tex"
    return config, MeshletFrameConfig(
        draw_capacity=2048, masked_draw_capacity=256, occlusion=True,
        object_precull=True, textured=tex, normal_mapped=tex,
        pbr_textures=tex, alpha_masked=tex, alpha_blend=tex,
        blend_textured=blend_textured)


def timed(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_frames(views, n: int):
    from chord_tpu_torch.renderer import DeviceView
    return DeviceView.stack([views.frame(i) for i in range(n)])


# --- bounds -------------------------------------------------------------------

def _nbytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _ops(name: str, args, kwargs) -> float:
    """f32 operations the call's data needs (0 for pure data movement)."""
    if name == "raster":
        # every (pixel row, subwindow group) the queue visits tests the
        # group's 16 triangles on 128 lanes: 5 plane evaluations (4 flops)
        # and the depth divide
        from chord_tpu_torch.ops import raster

        pair_win, starts, counts, sb, coefT, seeds, zclip, c = args
        nrows = raster._groups(pair_win, starts, counts, sb, c)[-1]
        return float(nrows.sum()) * c.tile_w * (raster.WINDOW // c.sub_s) * 21
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
    return 0.0


def bound(name: str, args, kwargs, out) -> tuple:
    """-> (bound ms, "bytes" | "operations")."""
    t_bytes = (_nbytes(args) + _nbytes(list(kwargs.values())) +
               _nbytes(out)) / HBM_BYTES_PER_S
    t_ops = _ops(name, args, kwargs) / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(name: str, args):
    """One PyTorch call computing the same function, where one exists: K3's
    rows are an index_select of the table along the flattened slot."""
    import torch

    if name != "row_gather":
        return None
    table, slot = args
    idx = torch.clamp(slot.reshape(-1), 0, table.shape[1] - 1).long()
    return lambda: torch.index_select(table, 1, idx)


def describe(name: str, args, kwargs) -> str:
    if name == "paged_texture":
        c, h, w = args[4].shape
        mode = "bilinear" if kwargs.get("bilinear", True) else "nearest"
        return f"C={c} {mode} {h}x{w}"
    return " ".join("x".join(map(str, a.shape)) for a in args
                    if hasattr(a, "shape"))[:80]


# --- phases -------------------------------------------------------------------

def check_kernels(path, scene):
    """Phase 4 for one path: each kernel of the path against its plain
    version on the path's own inputs (frame 1, so history and both
    occlusion phases are real)."""
    import torch

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.renderer import render_sequence_meshlet
    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    pools, inst, views, blend_tex = scene
    config, mcfg = configs(path, blend_tex)
    history = FrameHistory.empty(H, W, PH, PW, device=pools.positions.device)
    with kernels.capture_inputs() as captured:
        render_sequence_meshlet(pools, inst, first_frames(views, 2),
                                history, config, mcfg)
    torch.cuda.synchronize()
    rows = {}
    for k in kernels.KERNELS:
        calls = captured[k.name]
        if path not in k.paths:
            if calls:
                raise AssertionError(f"kernel {k.name} ran on path {path}")
            continue
        if not calls:
            raise RuntimeError(f"kernel {k.name} was not called by {path}")
        second = calls[len(calls) // 2:]
        err, per_call = 0.0, []
        for i, (args, kwargs) in enumerate(second):
            got = kernels.outputs_list(k.fn()(*args, **kwargs))
            ref = kernels.outputs_list(k.plain(*args, **kwargs))
            torch.cuda.synchronize()
            e = kernels.max_abs_err(got, ref)
            err = max(err, e)
            if e != 0.0:
                raise AssertionError(f"kernel {k.name} disagrees with its "
                                     f"plain version on {path}: {e}")
            ms = timed(lambda: k.fn()(*args, **kwargs), 20)
            plain_ms = timed(lambda: k.plain(*args, **kwargs),
                             3 if k.name == "raster" else 10)
            lib = library_call(k.name, args)
            lib_ms = timed(lib, 20) if lib else None
            b_ms, b_by = bound(k.name, args, kwargs, got)
            per_call.append(dict(call=f"#{i} " + describe(k.name, args,
                                                          kwargs), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms))
        tot = lambda key: sum(c[key] for c in per_call)
        by = max(per_call, key=lambda c: c["bound_ms"])["bound_by"]
        rows[k.name] = dict(
            name=k.name, path=path, route="cuda", source=k.source,
            replaces=k.replaces, max_abs_err=err, ms=tot("ms"),
            plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"), bound_by=by,
            library_ms=(tot("library_ms") if per_call[0]["library_ms"]
                        is not None else None),
            calls_per_frame=len(per_call), per_call=per_call)
        log(f"kernel {k.name} on {path}: {len(second)} calls compared, max "
            f"|kernel - plain| = {err} (tolerance 0); per call: " +
            "; ".join(f"[{c['call']}] {c['ms']:.4f} ms vs plain "
                      f"{c['plain_ms']:.4f}, bound {c['bound_ms']:.4f} "
                      f"({c['bound_by']})" +
                      (f", library {c['library_ms']:.4f}"
                       if c["library_ms"] is not None else "")
                      for c in per_call))
    return rows


def main_path(path, scene, card: str):
    """Phase 5 for one path: the 16-frame sequence, counted and timed."""
    import torch

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.renderer import render_sequence_meshlet
    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    pools, inst, views, blend_tex = scene
    config, mcfg = configs(path, blend_tex)
    history = FrameHistory.empty(H, W, PH, PW, device=pools.positions.device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    imgs, hist, stats = render_sequence_meshlet(
        pools, inst, views, history, config, mcfg, with_stats=True)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = kernels.launch_counts()
    worst = {k: int(v.max()) for k, v in stats.items()}
    log(f"{path} path: {FRAMES} frames in {first_s:.3f} s (first run), "
        f"worst-frame stats {worst}, launches {launches}")
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        if worst[k] != 0:
            raise AssertionError(f"{path}: worst-frame {k} = {worst[k]}")
    if int(stats["drawn_tris"].min()) <= 0:
        raise AssertionError(f"{path}: a frame drew no triangles")
    if tuple(imgs.shape) != (FRAMES, PH, PW, 3):
        raise AssertionError(f"{path}: image shape {tuple(imgs.shape)}")
    last = imgs[-1].float()
    if float(last.std()) < 1.0:
        raise AssertionError(f"{path}: the final image is constant")
    for name in ("depth", "tsr_color", "exposure", "hzb_flat"):
        if not bool(torch.isfinite(getattr(hist, name)).all()):
            raise AssertionError(f"{path}: history {name} is not finite")
    for k in kernels.KERNELS:
        n = launches[k.name]
        if path in k.paths and n <= 0:
            raise AssertionError(f"kernel {k.name} was not launched on the "
                                 f"{path} path")
        if path not in k.paths and n != 0:
            raise AssertionError(f"kernel {k.name} ran on the {path} path")
    if path == "geo_tex":
        if launches["paged_texture"] != 2 * FRAMES:
            raise AssertionError(f"K5 launched {launches['paged_texture']} "
                                 f"times, expected {2 * FRAMES}")
        if int(stats["draws_masked"].max()) <= 0:
            raise AssertionError("no masked draws on any frame")

    torch.cuda.synchronize()
    t0 = time.time()
    render_sequence_meshlet(pools, inst, views, history, config, mcfg,
                            with_stats=True)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / FRAMES * 1000.0
    log(f"{path} path: {ms:.3f} ms/frame (second run, {FRAMES} frames, "
        f"synchronize-bounded host clock) on {card}; mean u8 of the last "
        f"frame {float(last.mean()):.3f}")
    return {k.name: launches[k.name] for k in kernels.KERNELS
            if path in k.paths}, ms


def profile(path, scene, frames: int = 4) -> None:
    """Optional (--profile): torch.profiler over `frames` frames after a
    warm-up; prints the device time by kernel and the device's busy share
    of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from chord_tpu_torch.renderer import render_sequence_meshlet
    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    pools, inst, views, blend_tex = scene
    config, mcfg = configs(path, blend_tex)
    history = FrameHistory.empty(H, W, PH, PW, device=pools.positions.device)
    part = first_frames(views, frames)
    render_sequence_meshlet(pools, inst, part, history, config, mcfg)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        render_sequence_meshlet(pools, inst, part, history, config, mcfg)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events)
    n_launch = sum(e.count for e in events if e.self_device_time_total > 0)
    log(events.table(sort_by="self_device_time_total", row_limit=25))
    log(f"profile {path}: {frames} frames, host wall "
        f"{wall * 1000 / frames:.3f} ms/frame (profiler on), device busy "
        f"{dev_us / 1000 / frames:.3f} ms/frame = {dev_us / 1e6 / wall:.4f} "
        f"of wall, {n_launch / frames:.1f} device ops/frame")


def small_cross_check(path, dev):
    """Phase 6 for one path: tiny inputs, kernels on the GPU vs plain
    versions on the CPU."""
    import numpy as np
    import torch

    from chord_tpu_torch.asset.procedural import (build_bistro_like,
                                                  build_sponza_like)
    from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                          RendererConfig,
                                          render_sequence_meshlet)
    from chord_tpu_torch.rhi.framebuffer import FrameHistory
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    tex = path == "geo_tex"
    cfg = RendererConfig(width=128, height=64, post_width=192,
                         post_height=96, pair_capacity=4096, big_capacity=128,
                         tsr_mode="tile")
    mcfg = MeshletFrameConfig(draw_capacity=1024, masked_draw_capacity=256,
                              textured=tex, normal_mapped=tex,
                              pbr_textures=tex, alpha_masked=tex,
                              alpha_blend=tex, blend_textured=False)
    out = {}
    for d in (dev, torch.device("cpu")):
        b = (build_bistro_like(detail=1, textures=True) if tex
             else build_sponza_like(detail=1))
        cam = Camera(width=128, height=64)
        vs = []
        for i in range(3):
            if tex:
                cam.position = np.array([-45.0 + 70.0 * i / 15, 5.0, 4.0])
                cam.look_at(np.array([55.0, 3.0, -4.0]))
            else:
                cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
                cam.look_at(np.array([10.0, 2.0, 0.0]))
            vs.append(DeviceView.from_uniform(cam.view_uniform(i, jitter=True),
                                              device=d))
        imgs, _, st = render_sequence_meshlet(
            build_meshlet_pools(b, device=d,
                                texture_pool=getattr(b, "texture_pool",
                                                     None)),
            b.frame_instances(cam, device=d), DeviceView.stack(vs),
            FrameHistory.empty(64, 128, 96, 192, device=d), cfg, mcfg,
            with_stats=True)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    # the port must come from this checkout (fails, printing nothing,
    # where chip_smoke.py stands alone)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chord_tpu_torch.ops import _cuda
    from chord_tpu_torch.ops.kernels import PATHS

    smi = card_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    dev = torch.device("cuda", 0)
    t0 = time.time()
    path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"kernels built: {path.name} from {len(_cuda.sources())} sources in "
        f"{time.time() - t0:.2f} s")

    scenes = bench_scenes(dev, PATHS)
    rows, ms_per_frame = [], {}
    for p in PATHS:
        krows = check_kernels(p, scenes[p])
        launches, ms_per_frame[p] = main_path(p, scenes[p], smi)
        for name, n in launches.items():
            krows[name]["launches"] = n
        rows += list(krows.values())
        if "--profile" in sys.argv[1:]:
            profile(p, scenes[p])
    for p in PATHS:
        small_cross_check(p, dev)

    order = ("name", "path", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "calls_per_frame", "per_call")
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in rows],
                      "ms_per_frame": ms_per_frame}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
