#!/usr/bin/env python3
"""Compare versions of the port's ray tests (chord_tpu_torch/ops/rt.py) on
one GPU, in turns.

    python3 ray_ab.py NAME=DIR [NAME=DIR ...] [--rounds N] [--reps N]
        [--scan-reps N]

Each DIR holds a checkout (its chord_tpu_torch/ops/rt.py is the design);
"." stands for this one. The script builds the bench scenes of `all`,
`all_ddgi` and `all_exact` on the card (chip_smoke.bench_scenes), runs
frame 0 of each path (chip_smoke.run_path) with rt.trace recording its
calls, and keeps three: `all`'s probe rays (its first call), `all_ddgi`'s
DDGI rays (its first call: the probe update) and `all_exact`'s first RTAO
call (the BVH scan over the triangle BVH). Then each design's `trace` runs
on each kept call's inputs, the designs in turns (chip_smoke.alternate:
`--rounds` rounds of `--reps` calls, `--scan-reps` on the scan, whose
calls read the loop condition on the host and so include host gaps);
prints per call each design's median and the rounds' range, the rays
whose (t, leaf) differ between each design and the first, one JSON line
with every round, and last the card's name and power limit.

A design's rt.py is loaded as a module of this checkout's package
(chord_tpu_torch.ops), so it may import only what this checkout's ops
package holds.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

import chip_smoke

REPO = Path(__file__).resolve().parent
# (path, which of its frame-0 rt.trace calls, label)
CALLS = (("all", 0, "all probe rays"), ("all_ddgi", 0, "all_ddgi DDGI rays"),
         ("all_exact", 0, "all_exact RTAO call 0"))


def load_design(name: str, root: Path):
    """The design's rt module, loaded under this checkout's ops package."""
    if root.resolve() == REPO:
        from chord_tpu_torch.ops import rt
        return rt
    src = root / "chord_tpu_torch" / "ops" / "rt.py"
    spec = importlib.util.spec_from_file_location(
        f"chord_tpu_torch.ops._rt_{name}", src)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def capture(path: str, scene, dev) -> list:
    """[(origins, dirs, bvh, t_max)] of each rt.trace call of the path's
    frame 0."""
    from chord_tpu_torch.ops import rt

    config, mcfg = chip_smoke.configs(path, scene[3])
    hist = chip_smoke.history(config, mcfg, dev)
    calls, orig = [], rt.trace

    @functools.wraps(orig)      # rt.trace counts on the module's function
    def recorded(o, d, bvh, t_max=1e9, max_steps=None):
        calls.append((o.clone(), d.clone(), bvh, t_max))
        return orig(o, d, bvh, t_max, max_steps)

    rt.trace = recorded
    try:
        chip_smoke.run_path(path, scene, config, mcfg, hist, 0, 1)
    finally:
        rt.trace = orig
    torch.cuda.synchronize()
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("designs", nargs="+", help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--scan-reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ray_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    designs = {}
    for d in args.designs:
        name, root = d.split("=", 1)
        designs[name] = load_design(name, Path(root))
    t0 = time.time()
    paths = sorted({p for p, _, _ in CALLS})
    scenes = chip_smoke.bench_scenes(dev, chip_smoke.scene_paths(paths))
    print(f"scenes in {time.time() - t0:.1f} s", flush=True)
    rows = []
    for path, which, label in CALLS:
        o, d, bvh, t_max = capture(path, scenes[path], dev)[which]
        outs = {}
        for name, mod in designs.items():
            t, leaf = mod.trace(o, d, bvh, t_max)
            outs[name] = (t, leaf)
        first = next(iter(outs.values()))
        differ = {name: int(((t.view(torch.int32) !=
                              first[0].view(torch.int32)) |
                             (leaf != first[1])).sum())
                  for name, (t, leaf) in outs.items()}
        scan = _route(bvh) == "scan"
        reps = args.scan_reps if scan else args.reps
        fns = [functools.partial(mod.trace, o, d, bvh, t_max)
               for mod in designs.values()]
        runs = chip_smoke.alternate(fns, args.rounds, reps)
        row = dict(call=label, rays=int(o.numel() // 3),
                   route=_route(bvh),
                   hit_share=float((first[1] >= 0).float().mean()),
                   rays_differ_from_first=differ,
                   ms={n: statistics.median(r) for n, r in
                       zip(designs, runs)},
                   rounds={n: r for n, r in zip(designs, runs)})
        rows.append(row)
        for n, r in zip(designs, runs):
            print(f"{label} ({row['rays']} rays, {row['route']}) {n}: "
                  f"{chip_smoke.spread(r)} a call; rays that differ from "
                  f"{next(iter(designs))}: {differ[n]}", flush=True)
    print(json.dumps({"rt_trace": rows}))
    print(smi)
    return 0


def _route(bvh) -> str:
    """The route this checkout's rt.trace takes over `bvh` (no budget)."""
    from chord_tpu_torch.ops import rt

    if bvh.tri_planes is not None:
        return ("dense" if bvh.tri_planes.shape[0] <= rt.DENSE_TRI_LIMIT
                else "scan")
    return ("dense" if bvh.leaf_sphere.shape[0] <= rt.DENSE_LEAF_LIMIT
            else "scan")


if __name__ == "__main__":
    sys.exit(main())
