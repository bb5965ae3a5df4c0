#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (chord_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the default run
    python3 chip_smoke.py --profile    # + a torch.profiler breakdown

Phases (any failure raises and the script exits non-zero):

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the four hand-written kernels (chord_tpu_torch/csrc/*.cu) with
   nvcc into build/kernels/ and prints the build time.
3. Kernel vs plain version: runs two frames of the main path while
   recording every kernel call's inputs, then re-runs each kernel (K1
   raster, K2 mesh shader, K3 row gather, K4 tile reproject) and its plain
   PyTorch version on those inputs. Tolerance: 0 — the kernels are built
   with -fmad=false and round every operation as the plain versions do,
   so every output must match bit for bit. Times both (CUDA events).
4. The main path: the bench's `off` rung — the 2.6M-triangle procedural
   bistro (textures off), Nanite LOD cut on, 1280x720 render upscaled to
   1920x1080, 16 frames of render_sequence_meshlet(with_stats=True).
   Asserts worst-frame overflow 0, drawn triangles > 0, a non-constant
   finite image, and that every kernel was launched in that run; then runs
   the sequence again and reports ms/frame.
5. A small-input cross-check: the tiny atrium through the kernels on the
   GPU and through the plain versions on the CPU (the path the tests hold
   against chord_tpu) must give the same images within 2 u8 levels.

The line before the last is the nvidia-smi name/power-limit line, the one
before that the per-kernel JSON; the last line is
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_scene(dev):
    """The bench's bistro (bench.py:88-100, textures off) and its camera
    path (bench.py:112-131)."""
    import numpy as np

    from chord_tpu_torch.asset.procedural import build_bistro_like
    from chord_tpu_torch.native import available
    from chord_tpu_torch.renderer import DeviceView
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    t0 = time.time()
    b = build_bistro_like(detail=3, target_tris=2_600_000, textures=False)
    if not available():
        raise RuntimeError("the native Nanite builder did not load")
    pools = build_meshlet_pools(b, nanite=True, device=dev)
    n_src = sum(b.meshes[m].num_triangles for m, _, _ in b.instances)
    cam = Camera(width=W, height=H)
    views = []
    for i in range(FRAMES):
        t = i / (FRAMES - 1)
        cam.position = np.array([-45.0 + 70.0 * t, 5.0, 4.0])
        cam.look_at(np.array([55.0, 3.0, -4.0]))
        views.append(DeviceView.from_uniform(cam.view_uniform(i), device=dev))
    inst = b.frame_instances(cam, device=dev)
    log(f"scene: {n_src} source tris, {pools.num_meshlets} meshlets, "
        f"{pools.num_pairs} pairs, built in {time.time() - t0:.2f} s "
        f"(nanite on)")
    return pools, inst, DeviceView.stack(views)


def configs():
    from chord_tpu_torch.renderer import MeshletFrameConfig, RendererConfig

    config = RendererConfig(width=W, height=H, post_width=PW, post_height=PH,
                            pair_capacity=8192, big_capacity=64,
                            enable_bloom=True, enable_tsr=True,
                            tsr_mode="tile")
    return config, MeshletFrameConfig(draw_capacity=2048, occlusion=True,
                                      object_precull=True)


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


def check_kernels(pools, inst, views, history):
    """Phase 3: each kernel against its plain version on the main path's
    own inputs (frame 1 of the path, so history and both raster phases
    are real)."""
    import torch

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.renderer import render_sequence_meshlet

    config, mcfg = configs()
    with kernels.capture_inputs() as captured:
        render_sequence_meshlet(pools, inst, first_frames(views, 2),
                                history, config, mcfg)
    torch.cuda.synchronize()
    rows = {}
    for k in kernels.KERNELS:
        calls = captured[k.name]
        if not calls:
            raise RuntimeError(f"kernel {k.name} was not called by the frame")
        # the calls of the second frame (all of them for K1-K3: both
        # raster phases, both row-table fetches)
        second = calls[len(calls) // 2:]
        err = 0.0
        for args, kwargs in second:
            got = kernels.outputs_list(k.fn()(*args, **kwargs))
            ref = kernels.outputs_list(k.plain(*args, **kwargs))
            torch.cuda.synchronize()
            err = max(err, kernels.max_abs_err(got, ref))
        args, kwargs = second[0]
        ms = timed(lambda: k.fn()(*args, **kwargs), 20)
        plain_ms = timed(lambda: k.plain(*args, **kwargs),
                         3 if k.name == "raster" else 10)
        log(f"kernel {k.name}: {len(second)} calls compared, max |kernel - "
            f"plain| = {err} (tolerance 0), {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms")
        if err != 0.0:
            raise AssertionError(f"kernel {k.name} disagrees with its plain "
                                 f"version: max abs err {err}")
        rows[k.name] = dict(name=k.name, route="cuda", source=k.source,
                            replaces=k.replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms)
    return rows


def main_path(pools, inst, views, history, card: str):
    """Phase 4: the 16-frame sequence, counted and timed."""
    import torch

    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.renderer import render_sequence_meshlet

    config, mcfg = configs()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    imgs, hist, stats = render_sequence_meshlet(
        pools, inst, views, history, config, mcfg, with_stats=True)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = kernels.launch_counts()
    worst = {k: int(v.max()) for k, v in stats.items()}
    log(f"main path: {FRAMES} frames in {first_s:.3f} s (first run), "
        f"worst-frame stats {worst}, launches {launches}")
    for k in ("bin_overflow", "draw_overflow", "active_overflow"):
        if worst[k] != 0:
            raise AssertionError(f"worst-frame {k} = {worst[k]}")
    if int(stats["drawn_tris"].min()) <= 0:
        raise AssertionError("a frame drew no triangles")
    if tuple(imgs.shape) != (FRAMES, PH, PW, 3):
        raise AssertionError(f"image shape {tuple(imgs.shape)}")
    last = imgs[-1].float()
    if float(last.std()) < 1.0:
        raise AssertionError("the final image is constant")
    for name in ("depth", "tsr_color", "exposure", "hzb_flat"):
        if not bool(torch.isfinite(getattr(hist, name)).all()):
            raise AssertionError(f"history {name} is not finite")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    torch.cuda.synchronize()
    t0 = time.time()
    render_sequence_meshlet(pools, inst, views, history, config, mcfg,
                            with_stats=True)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / FRAMES * 1000.0
    log(f"main path: {ms:.3f} ms/frame (second run, {FRAMES} frames, "
        f"synchronize-bounded host clock) on {card}; mean u8 of the last "
        f"frame {float(last.mean()):.3f}")
    return launches, ms


def profile(pools, inst, views, history, frames: int = 4) -> None:
    """Optional (--profile): torch.profiler over `frames` frames after a
    warm-up; prints the device time by kernel and the device's busy share
    of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from chord_tpu_torch.renderer import render_sequence_meshlet

    config, mcfg = configs()
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
    log(f"profile: {frames} frames, host wall {wall * 1000 / frames:.3f} "
        f"ms/frame (profiler on), device busy {dev_us / 1000 / frames:.3f} "
        f"ms/frame = {dev_us / 1e6 / wall:.4f} of wall, "
        f"{n_launch / frames:.1f} device ops/frame")


def small_cross_check(dev):
    """Phase 5: the tiny atrium, kernels on the GPU vs plain on the CPU."""
    import numpy as np
    import torch

    from chord_tpu_torch.asset.procedural import build_sponza_like
    from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                          RendererConfig,
                                          render_sequence_meshlet)
    from chord_tpu_torch.rhi.framebuffer import FrameHistory
    from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
    from chord_tpu_torch.utils.camera import Camera

    b = build_sponza_like(detail=1)
    cfg = RendererConfig(width=128, height=64, post_width=192,
                         post_height=96, pair_capacity=4096, big_capacity=128,
                         tsr_mode="tile")
    mcfg = MeshletFrameConfig(draw_capacity=1024)
    out = {}
    for d in (dev, torch.device("cpu")):
        cam = Camera(width=128, height=64)
        cam.position = np.array([-15.0, 4.0, 0.0])
        cam.look_at(np.array([10.0, 2.0, 0.0]))
        vs = []
        for i in range(3):
            cam.position = np.array([-15.0 + 0.5 * i, 4.0, 0.3 * i])
            vs.append(DeviceView.from_uniform(cam.view_uniform(i, jitter=True),
                                              device=d))
        imgs, _, st = render_sequence_meshlet(
            build_meshlet_pools(b, device=d), b.frame_instances(cam, device=d),
            DeviceView.stack(vs), FrameHistory.empty(64, 128, 96, 192,
                                                     device=d),
            cfg, mcfg, with_stats=True)
        out[d.type] = (imgs.cpu().numpy().astype(np.int32),
                       {k: v.cpu().tolist() for k, v in st.items()})
    diff = np.abs(out["cuda"][0] - out["cpu"][0])
    frac = float((diff <= 2).mean())
    log(f"small cross-check (GPU kernels vs CPU plain): stats equal "
        f"{out['cuda'][1] == out['cpu'][1]}, max u8 diff {int(diff.max())}, "
        f"within 2 levels {frac}")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"stats differ: {out['cuda'][1]} vs "
                             f"{out['cpu'][1]}")
    if frac < 0.999:
        raise AssertionError(f"only {frac} of u8 values within 2 levels")


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

    smi = card_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    dev = torch.device("cuda", 0)
    t0 = time.time()
    path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"kernels built: {path.name} in {time.time() - t0:.2f} s")

    from chord_tpu_torch.rhi.framebuffer import FrameHistory

    pools, inst, views = bench_scene(dev)
    history = FrameHistory.empty(H, W, PH, PW, device=dev)
    rows = check_kernels(pools, inst, views, history)
    launches, ms = main_path(pools, inst, views, history, smi)
    if "--profile" in sys.argv[1:]:
        profile(pools, inst, views, history)
    small_cross_check(dev)

    for name, n in launches.items():
        rows[name]["launches"] = n
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    kern = [{k: rows[n][k] for k in order} for n in rows]
    print(json.dumps({"kernels": kern, "ms_per_frame": ms}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
