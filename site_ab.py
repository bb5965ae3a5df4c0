#!/usr/bin/env python3
"""Compare versions of the port's frame (the whole chord_tpu_torch
package) on one GPU, stage by stage and frame by frame, in turns.

    python3 site_ab.py NAME=DIR [NAME=DIR ...] [--rounds N] [--reps N]
        [--frame-runs N]

Each DIR holds a checkout ("." stands for this one). A design other than
this checkout is its chord_tpu_torch package copied under build/ab/pkgs/
NAME as `chord_tpu_torch_NAME` (its relative imports stay inside it; its
kernels build from its own csrc into its own build directory), so every
design runs its own code in this one process. This checkout builds the
bench scenes of `all` and `all_exact` (chip_smoke.bench_scenes) and
records, from its own frames, the inputs of four stages: the specular GI
(renderer.meshlet_frame._specular_gi, the `gi.specular` span and its
filter chain), the G-buffer resolve (ops.shading.resolve_gbuffer_raster_rt,
with the per-object motion delta) and the PCSS prepass
(ops.shadow.shadow_prepass) of `all`'s fifth frame (every cascade holding
depth), and RTAO (ops.gi.rtao, the
`gi.ao` span) of `all_exact`'s first frame, whose four traces take the
BVH scan for seconds: RTAO is timed with rt.trace stubbed, so its time is
its directions and the rest of its own ops. Each design's stage then runs
on those inputs, the designs in turns (`--rounds` rounds of `--reps`
calls, the order reversed every other round), each call timed on the
device (chip_smoke.timed: queued behind a device-side sleep) and on the
host (the wall clock around the calls, ended by a synchronize: these
frame paths are host-bound), and each design's kernel launches a call
(torch.profiler's cudaLaunchKernel events; and a frame's, over two
frames of `all`); then `all`'s 16-frame sequence through
each design's render_sequence_meshlet from a fresh history, in turns
(`--frame-runs` each), ms/frame on the host clock; then the same runs
with the specular GI, the resolve and the PCSS prepass of every frame
timed between two synchronizes (the stages as the frame calls them). Prints each
stage's medians with the rounds' range, one JSON line with every round,
and last the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

import torch

import chip_smoke

REPO = Path(__file__).resolve().parent
PKG_DIR = REPO / "build" / "ab" / "pkgs"
# the frame of `all` whose specular GI and PCSS prepass are recorded
RECORD_FRAME = 4


def load_design(name: str, root: Path):
    """The design's package: this checkout's, or DIR's copied under
    PKG_DIR/NAME as chord_tpu_torch_NAME with its csrc where its _cuda
    looks for it."""
    if root.resolve() == REPO:
        return importlib.import_module("chord_tpu_torch")
    dst = PKG_DIR / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root / "chord_tpu_torch", dst / f"chord_tpu_torch_{name}",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(root / "chord_tpu_torch" / "csrc",
                    dst / "chord_tpu_torch" / "csrc")
    sys.path.insert(0, str(dst))
    return importlib.import_module(f"chord_tpu_torch_{name}")


def _modules(pkg):
    return {k: importlib.import_module(f"{pkg.__name__}.{m}") for k, m in (
        ("frame", "renderer.meshlet_frame"), ("shadow", "ops.shadow"),
        ("gi", "ops.gi"), ("rt", "ops.rt"), ("renderer", "renderer"),
        ("shading", "ops.shading"))}


def record(scenes, dev) -> dict:
    """This checkout's inputs of each stage: {stage: (args, kwargs)}."""
    from chord_tpu_torch.ops import gi, shading, shadow
    from chord_tpu_torch.renderer import meshlet_frame

    out = {}

    def recorder(mod, attr, key, when):
        orig = getattr(mod, attr)

        @functools.wraps(orig)
        def rec(*args, **kwargs):
            if when():
                out[key] = (args, kwargs)
            return orig(*args, **kwargs)
        setattr(mod, attr, rec)
        return orig

    frame = {"i": 0}

    def at():
        return frame["i"] == RECORD_FRAME

    origs = [(meshlet_frame, "_specular_gi",
              recorder(meshlet_frame, "_specular_gi", "specular", at)),
             (shadow, "shadow_prepass",
              recorder(shadow, "shadow_prepass", "prepass", at)),
             (shading, "resolve_gbuffer_raster_rt",
              recorder(shading, "resolve_gbuffer_raster_rt", "resolve",
                       at))]
    try:
        config, mcfg = chip_smoke.configs("all", scenes["all"][3])
        hist = chip_smoke.history(config, mcfg, dev)
        for i in range(RECORD_FRAME + 1):
            frame["i"] = i
            hist = chip_smoke.run_path("all", scenes["all"], config, mcfg,
                                       hist, i, i + 1)[1]
        frame["i"] = -1                 # `all_exact` records RTAO only
        origs.append((gi, "rtao", recorder(gi, "rtao", "rtao",
                                           lambda: True)))
        config, mcfg = chip_smoke.configs("all_exact",
                                          scenes["all_exact"][3])
        hist = chip_smoke.history(config, mcfg, dev)
        chip_smoke.run_path("all_exact", scenes["all_exact"], config, mcfg,
                            hist, 0, 1)
    finally:
        for mod, attr, orig in origs:
            setattr(mod, attr, orig)
    torch.cuda.synchronize()
    return out


def _stub_trace(o, d, bvh, t_max=1e9, max_steps=None):
    shape = o.shape[:-1]
    return (torch.full(shape, float(t_max), device=o.device),
            torch.full(shape, -1, dtype=torch.int32, device=o.device))


def stage_fn(mods, stage: str, args, kwargs):
    """A design's call of `stage` on the recorded inputs."""
    if stage == "specular":
        return lambda: mods["frame"]._specular_gi(*args, **kwargs)
    if stage == "prepass":
        return lambda: mods["shadow"].shadow_prepass(*args, **kwargs)
    if stage == "resolve":
        return lambda: mods["shading"].resolve_gbuffer_raster_rt(*args,
                                                                 **kwargs)

    def rtao():
        rt, orig = mods["rt"], mods["rt"].trace
        rt.trace = _stub_trace
        try:
            return mods["gi"].rtao(*args, **kwargs)
        finally:
            rt.trace = orig
    return rtao


def measure(fn, reps: int) -> tuple:
    """-> (device ms, host wall ms) per call."""
    dev_ms = chip_smoke.timed(fn, reps)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return dev_ms, (time.perf_counter() - t0) * 1e3 / reps


def in_turns(fns: dict, rounds: int, reps: int) -> dict:
    """{design: {"device": [ms a round], "host": [ms a round]}}."""
    names = list(fns)
    out = {n: {"device": [], "host": []} for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            d, h = measure(fns[n], reps)
            out[n]["device"].append(d)
            out[n]["host"].append(h)
    return out


def _stage_timers(mods, store: dict):
    """Wrap the design's specular GI, resolve and PCSS prepass (module
    attributes, which its frame calls) with a host clock between two
    synchronizes; each call's ms goes to store[stage] -> what to
    restore."""
    undo = []
    for stage, mod, attr in (("specular", mods["frame"], "_specular_gi"),
                             ("resolve", mods["shading"],
                              "resolve_gbuffer_raster_rt"),
                             ("prepass", mods["shadow"], "shadow_prepass")):
        fn = getattr(mod, attr)

        @functools.wraps(fn)
        def timed_stage(*a, _fn=fn, _out=store[stage], **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            _out.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(mod, attr, timed_stage)
        undo.append((mod, attr, fn))
    return undo


def frame_runs(designs: dict, scene, dev, runs: int,
               timers: bool = False) -> tuple:
    """`all`'s 16 frames through each design's render_sequence_meshlet,
    in turns -> ({design: [ms/frame a run]}, {design: {stage: [ms a
    call]}}: with `timers`, each frame's specular GI, resolve and PCSS
    prepass timed between synchronizes, which the run's ms/frame then
    includes)."""
    config, mcfg = chip_smoke.configs("all", scene[3])
    pools, inst, views, _, bvh = scene
    n = chip_smoke.FRAMES
    out = {k: [] for k in designs}
    stages = {k: {"specular": [], "resolve": [], "prepass": []}
              for k in designs}
    for mods in designs.values():     # warm up: first-use builds and caches
        mods["renderer"].render_sequence_meshlet(
            pools, inst, chip_smoke.frames(views, 0, 2),
            chip_smoke.history(config, mcfg, dev), config, mcfg, bvh=bvh,
            with_stats=True)
    for r in range(runs):
        for name in (list(designs) if r % 2 == 0 else list(designs)[::-1]):
            mods = designs[name]
            undo = _stage_timers(mods, stages[name]) if timers else []
            try:
                hist = chip_smoke.history(config, mcfg, dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mods["renderer"].render_sequence_meshlet(
                    pools, inst, chip_smoke.frames(views, 0, n), hist,
                    config, mcfg, bvh=bvh, with_stats=True)
                torch.cuda.synchronize()
                out[name].append((time.perf_counter() - t0) * 1e3 / n)
            finally:
                for mod, attr, fn in undo:
                    setattr(mod, attr, fn)
    return out, stages


def launches_of(fn, calls: int = 3) -> float:
    """Kernel launches (cudaLaunchKernel events under torch.profiler) of
    one call of fn, counted over `calls` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "cudaLaunchKernel") / calls


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("designs", nargs="+", help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frame-runs", type=int, default=3)
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        print("site_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    designs = {}
    for spec in args.designs:
        name, root = spec.split("=", 1)
        designs[name] = _modules(load_design(name, Path(root)))
    t0 = time.time()
    scenes = chip_smoke.bench_scenes(dev, chip_smoke.scene_paths(
        ["all", "all_exact"]))
    inputs = record(scenes, dev)
    print(f"site_ab: scenes and recorded stage inputs in "
          f"{time.time() - t0:.1f} s", flush=True)
    result = {}
    where = {"prepass": f"all frame {RECORD_FRAME}",
             "specular": f"all frame {RECORD_FRAME}",
             "resolve": f"all frame {RECORD_FRAME}",
             "rtao": "all_exact frame 0, traces stubbed"}
    for stage in ("prepass", "specular", "resolve", "rtao"):
        a, kw = inputs[stage]
        fns = {n: stage_fn(m, stage, a, kw) for n, m in designs.items()}
        for fn in fns.values():          # build each design's kernels
            fn()
        reps = max(2, args.reps // 4) if stage == "rtao" else args.reps
        runs = in_turns(fns, args.rounds, reps)
        result[stage] = runs
        for n, r in runs.items():
            print(f"{stage} ({where[stage]}) design {n}: device "
                  f"{chip_smoke.spread(r['device'])}, "
                  f"host {chip_smoke.spread(r['host'])} a call, medians of "
                  f"{args.rounds} rounds of {reps} in turns", flush=True)
        for n, fn in fns.items():
            result[f"{stage}_launches_{n}"] = launches_of(fn)
            print(f"{stage} design {n}: "
                  f"{result[f'{stage}_launches_{n}']:.1f} kernel launches a "
                  "call (torch.profiler)", flush=True)
    config, mcfg = chip_smoke.configs("all", scenes["all"][3])
    pools, inst, views, _, bvh = scenes["all"]
    for n, mods in designs.items():
        def two_frames(mods=mods):
            mods["renderer"].render_sequence_meshlet(
                pools, inst, chip_smoke.frames(views, 4, 6),
                chip_smoke.history(config, mcfg, dev), config, mcfg,
                bvh=bvh, with_stats=True)
        result[f"all_frame_launches_{n}"] = launches_of(two_frames,
                                                        calls=2) / 2
        print(f"`all` frames 4-5 from a fresh history, design {n}: "
              f"{result[f'all_frame_launches_{n}']:.1f} kernel launches a "
              "frame (torch.profiler)", flush=True)
    runs, _ = frame_runs(designs, scenes["all"], dev, args.frame_runs)
    result["all_ms_per_frame"] = runs
    for n, r in runs.items():
        print(f"all 16 frames design {n}: {statistics.median(r):.3f} "
              f"ms/frame median of {len(r)} runs in turns "
              f"({', '.join(f'{v:.3f}' for v in r)})", flush=True)
    _, stages = frame_runs(designs, scenes["all"], dev, args.frame_runs,
                           timers=True)
    result["all_in_frame_stage_ms"] = stages
    for n, st in stages.items():
        for stage, ms in st.items():
            ms = ms[chip_smoke.FRAMES:]     # the first run warms up
            print(f"{stage} inside `all`'s frames, design {n}: "
                  f"{statistics.median(ms):.4f} ms a call (median of "
                  f"{len(ms)} calls, min {min(ms):.4f}, max {max(ms):.4f};"
                  " host clock between synchronizes)", flush=True)
    print(json.dumps(result))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
