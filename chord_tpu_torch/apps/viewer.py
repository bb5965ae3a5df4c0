"""Headless viewer (port of apps/viewer.py, the `flower` application analog).

Loads a scene (a builtin procedural one, a .chtp scene asset or a
glTF/GLB file), flies a camera path, renders it through MeshletRenderer
(the GPU-driven meshlet frame) and writes PNG frames (+ optional GIF
turntable). It runs on the card unless given `--device cpu`; without
a card and without that flag it raises.

Examples:
    python -m chord_tpu_torch.apps.viewer --scene sponza --frames 8 --out out
    python -m chord_tpu_torch.apps.viewer --scene assets/demo_street.glb \\
        --shadows --atmosphere --orbit --gif
    python -m chord_tpu_torch.apps.viewer --scene scene.chtp --device cpu \\
        --width 192 --height 108 --draw-capacity 1024 --pair-capacity 4096
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.log import get_logger

log = get_logger("viewer")


def _frame_bounds(b):
    """The camera position and target that frame the builder's meshes."""
    lo = np.min([m.local_aabb()[0] for m in b.meshes], 0)
    hi = np.max([m.local_aabb()[1] for m in b.meshes], 0)
    c = (lo + hi) / 2
    r = float(np.linalg.norm(hi - lo)) * 0.9 + 1.0
    return c + np.array([r, r * 0.4, r]), c


def build_scene(name: str, device=None):
    """-> (SceneBuilder, camera position, target). `name` is sponza,
    bistro, bistro_tex, interior, nanite, a .chtp scene asset (loaded
    through SceneSubsystem with the builtin mesh library) or a glTF/GLB
    file (its textures into a TexturePool, on `builder.texture_pool`)."""
    from ..asset import procedural as proc
    from ..asset.gltf import into_builder, load_gltf
    from ..asset.texture import TexturePool
    from ..rhi.scene_arrays import SceneBuilder

    if name == "sponza":
        return proc.build_sponza_like(detail=2), np.array([-15.0, 4.0, 3.0]), \
            np.array([10.0, 2.0, -2.0])
    if name == "bistro":
        return proc.build_bistro_like(detail=2), \
            np.array([-40.0, 5.0, 4.0]), np.array([50.0, 3.0, -4.0])
    if name == "bistro_tex":   # textured variant (paged-sampler showcase)
        return proc.build_bistro_like(detail=2, textures=True), \
            np.array([-40.0, 5.0, 4.0]), np.array([50.0, 3.0, -4.0])
    if name == "interior":     # BASELINE config #4: indoor diffuse GI
        return proc.build_bistro_interior(detail=2), \
            np.array([-6.0, 2.2, 3.6]), np.array([6.0, 1.2, -2.0])
    if name == "nanite":
        return proc.build_nanite_stress(rings=64), \
            np.array([45.0, 10.0, 30.0]), np.array([0.0, 2.0, 0.0])
    p = Path(name)
    if p.suffix == ".chtp":
        # scene files reference meshes / materials by key; the builtin.*
        # primitives are always in the library
        from ..scene import Scene, SceneSubsystem
        from ..utils.camera import Camera

        sub = SceneSubsystem(device=device)
        sub.register_builtin_meshes()
        sub.set_scene(Scene.load(p))
        sub.frame_state(sub.scene.tick(1 / 60)[0], Camera())
        b = sub._builder
        b.texture_pool = None
        return (b, *_frame_bounds(b))
    tp = TexturePool(512)
    b = into_builder(load_gltf(p, texture_pool=tp), SceneBuilder())
    b.texture_pool = tp if tp.textures else None
    return (b, *_frame_bounds(b))


def bounds_overlay(img_u8: np.ndarray, builder, cam, view) -> np.ndarray:
    """Wireframe instance bounding spheres over the frame (the reference's
    debug-line pass, renderer/debugline.cpp, fed from the host)."""
    from ..ops.debug_draw import (overlay_lines, project_segments,
                                  sphere_segments)

    segs = []
    for mesh_id, _mat, l2w in builder.instances[:64]:
        mesh = builder.meshes[mesh_id]
        c = mesh.positions.mean(0)
        rad = float(np.linalg.norm(mesh.positions - c, axis=1).max())
        cw = np.append(c, 1.0).astype(np.float64) @ l2w
        scale = float(np.linalg.norm(l2w[:3, :3], axis=1).max())
        segs.append(sphere_segments(cw[:3] - cam.position,
                                    rad * scale, segs=16))
    if not segs:
        return img_u8
    vp = torch.from_numpy(np.asarray(view.translated_world_to_clip_nojitter,
                                     np.float32))
    px, ok = project_segments(torch.from_numpy(np.concatenate(segs)), vp,
                              img_u8.shape[1], img_u8.shape[0])
    out = overlay_lines(torch.from_numpy(img_u8).float() / 255.0, px, ok,
                        color=(0.1, 1.0, 0.2), width_px=1.0)
    return torch.clamp(out * 255.0, 0, 255).to(torch.uint8).numpy()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scene", default="sponza",
                    help="sponza | bistro | bistro_tex | interior | nanite | "
                         "path/to/scene.chtp | path/to/model.glb")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the camera around the target")
    ap.add_argument("--out", default="chord_view",
                    help="directory for the PNG frames")
    ap.add_argument("--gif", action="store_true")
    ap.add_argument("--debug", default="none",
                    choices=["none", "meshlet", "lod", "normal", "depth",
                             "disocclusion", "motion", "gi", "specular"])
    ap.add_argument("--overlay", default="none",
                    choices=["none", "bounds"],
                    help="wireframe overlay: instance bounding spheres "
                         "(reference: debugline.cpp)")
    ap.add_argument("--no-nanite", action="store_true")
    ap.add_argument("--shadows", action="store_true")
    ap.add_argument("--atmosphere", action="store_true")
    ap.add_argument("--gi", action="store_true")
    ap.add_argument("--gi-mode", default="probe",
                    choices=["probe", "ddgi", "cache"],
                    help="probe = screen-probe stage; ddgi = probe volumes "
                         "over the BVH; cache = world SH cache only")
    ap.add_argument("--gi-rt", action="store_true",
                    help="software-BVH rays for probe rays + SSR misses "
                         "(offscreen geometry)")
    ap.add_argument("--rt-exact", action="store_true",
                    help="triangle-exact BVH leaves; default = meshlet "
                         "proxies")
    ap.add_argument("--ssr", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one). `--device cpu` runs the kernels' plain "
                         "versions on the CPU")
    ap.add_argument("--draw-capacity", type=int, default=8192,
                    help="visible-meshlet draw capacity")
    ap.add_argument("--pair-capacity", type=int, default=16384,
                    help="raster work-queue (tile,window) pair capacity")
    ap.add_argument("--no-occlusion", action="store_true",
                    help="skip the two-phase HZB occlusion passes")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler chrome trace of the "
                         "frames to DIR/trace.json (the passes are "
                         "record_function spans)")
    ap.add_argument("--stats", action="store_true",
                    help="print a per-span ms/frame table (device ms on "
                         "the card, host ms on the CPU) and the draw stats "
                         "after rendering (the reference's System-widget "
                         "GPU timer readout)")
    return ap.parse_args(argv)


def resolve_device(device) -> torch.device:
    """The run's device: the card unless `device` names another; without
    a card and without --device cpu this raises (nothing falls back)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    return dev


def frame_config(args, b):
    """The viewer's (RendererConfig, MeshletFrameConfig) for scene `b`:
    textured shading when it has a texture pool, the masked / blend
    buckets when its materials have them."""
    from ..renderer import MeshletFrameConfig, RendererConfig

    tex = getattr(b, "texture_pool", None) is not None
    return (RendererConfig(width=args.width, height=args.height,
                           pair_capacity=args.pair_capacity,
                           big_capacity=128),
            MeshletFrameConfig(
                draw_capacity=args.draw_capacity,
                occlusion=not args.no_occlusion, shadows=args.shadows,
                atmosphere=args.atmosphere, gi=args.gi,
                debug_mode=args.debug, textured=tex, normal_mapped=tex,
                pbr_textures=tex, gi_mode=args.gi_mode, gi_rt=args.gi_rt,
                rt_granularity="triangle" if args.rt_exact else "meshlet",
                ssr=args.ssr,
                alpha_masked=any(m.alpha_mode == "mask"
                                 for m in b.materials),
                alpha_blend=any(m.alpha_mode == "blend"
                                for m in b.materials),
                blend_textured=any(m.alpha_mode == "blend"
                                   and m.base_color_texture >= 0
                                   for m in b.materials)))


def run(args) -> dict:
    """Render `args.frames` frames and write them -> {"images": [(H,W,3)
    u8], "stats": [per-frame stats], "renderer", "pools", "builder"}."""
    from ..native import available
    from ..renderer import MeshletRenderer
    from ..rhi.meshlet_scene import build_meshlet_pools
    from ..utils.camera import Camera

    dev = resolve_device(args.device)
    b, cam_pos, target = build_scene(args.scene, device=dev)
    use_nanite = available() and not args.no_nanite
    pools = build_meshlet_pools(b, nanite=use_nanite,
                                texture_pool=getattr(b, "texture_pool", None),
                                device=dev)
    log.info("scene ready: %d meshlets, %d pairs, nanite=%s, device %s",
             pools.num_meshlets, pools.num_pairs, use_nanite, dev)
    r = MeshletRenderer(*frame_config(args, b))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cam = Camera(width=args.width, height=args.height)
    result = dict(images=[], stats=[], renderer=r, pools=pools, builder=b)
    prof = None
    if args.trace or args.stats:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
    with prof or contextlib.nullcontext():
        _render_loop(args, b, cam, cam_pos, target, r, pools, dev, result,
                     out_dir)
    if prof is not None and args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / "trace.json"))
        log.info("wrote %s", Path(args.trace) / "trace.json")
    if args.stats:
        _print_stats(prof, args.frames, dev)
    if args.gif and len(result["images"]) > 1:
        _write_gif(result["images"], out_dir)
    return result


def _print_stats(prof, frames: int, dev) -> None:
    """Per-span ms a frame from the profiler (the flower System widget's
    labeled per-pass timings): device time on the card, host time on the
    CPU."""
    on_card = dev.type == "cuda"
    key = "self_device_time_total" if on_card else "self_cpu_time_total"
    rows = sorted(prof.key_averages(), key=lambda e: getattr(e, key),
                  reverse=True)
    div = max(frames, 1) * 1000.0
    total = sum(getattr(e, key) for e in rows)
    print(f"== per-op {'device' if on_card else 'host'} ms/frame "
          f"(total {total / div:.2f}) ==")
    for e in rows[:25]:
        print(f"{getattr(e, key) / div:8.3f}  {e.key}")


def _render_loop(args, b, cam, cam_pos, target, r, pools, dev, result,
                 out_dir) -> None:
    from PIL import Image

    for i in range(args.frames):
        if args.orbit:
            ang = i / max(args.frames, 1) * 2 * np.pi
            rad = np.linalg.norm((cam_pos - target)[[0, 2]])
            cam.position = target + np.array(
                [rad * np.cos(ang), (cam_pos - target)[1],
                 rad * np.sin(ang)])
        else:
            cam.position = cam_pos + np.array([0.05 * i, 0.0, 0.0])
        cam.look_at(target)
        inst = b.frame_instances(cam, device=dev)
        t0 = time.time()
        view_u = cam.view_uniform(i)
        img, stats = r.render(pools, inst, view_u)
        img = img.cpu().numpy()
        if args.overlay == "bounds":
            img = bounds_overlay(img, b, cam, view_u)
        log.info("frame %d: %.1f ms, drawn=%d overflow=%d", i,
                 (time.time() - t0) * 1000, int(stats["drawn_tris"]),
                 int(stats["bin_overflow"]))
        Image.fromarray(img).save(out_dir / f"frame_{i:04d}.png")
        result["images"].append(img)
        result["stats"].append(stats)
    log.info("wrote %d frame(s) to %s", len(result["images"]), out_dir)


def _write_gif(images, out_dir) -> None:
    from PIL import Image

    frames = [Image.fromarray(i) for i in images]
    frames[0].save(out_dir / "turntable.gif", save_all=True,
                   append_images=frames[1:], duration=100, loop=0)
    log.info("wrote turntable.gif")


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
