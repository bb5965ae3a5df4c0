#!/usr/bin/env python3
"""Compare designs of the port's CUDA kernels on one GPU, in turns.

    python3 kernel_ab.py NAME=DIR [NAME=DIR ...] --paths P[,P...]
        [--kernels K[,K...]] [--rounds N] [--reps N]

Each DIR holds a `csrc/` directory of kernel sources; "." stands for this
checkout (chord_tpu_torch/csrc). The script builds one library per design
(nvcc's -Xptxas -v lines printed under the design's name), captures the
kernel calls of one frame of each frame path (chip_smoke.capture_frame) or
of the repro tool's `tm_pallas` first call (path `repro_eval`), with this
checkout's kernels, and then, for each captured call of each kernel in
--kernels (default: every kernel of the paths), for each design whose
library exports the kernel's entry point: runs it against the plain
version (tolerance 0; a mismatch fails the run) and times it. The designs
run in turns, `--rounds` rounds of `--reps` calls each, the order
reversed every other round (chip_smoke.alternate: device time, queued
behind a device-side sleep); a kernel with a library yardstick
(chip_smoke.library_call) has that call in the turns as well. Prints per
call each design's median and the rounds' range, then one JSON line with
every round; the last line is the card's name and power limit.

A design's library replaces the checkout's for its turn only; the plain
versions and the inputs are this checkout's. So the designs compared must
keep the C entry points' signatures.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import chip_smoke


def entry_point(k, args, kwargs) -> str:
    """The C entry point the kernel's wrapper launches (one call)."""
    from chord_tpu_torch.ops import _cuda

    seen = []
    launch = _cuda.launch
    _cuda.launch = lambda name, *a: (seen.append(name), launch(name, *a))[1]
    try:
        k.fn()(*args, **kwargs)
    finally:
        _cuda.launch = launch
    return seen[0]


def capture(path, dev, scenes):
    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.tools import repro_eval_kernel as tool

    if path != "repro_eval":
        return chip_smoke.capture_frame(path, scenes[path])[0]
    with kernels.capture_inputs() as captured:
        tool.run_variant("tm_pallas", dev, 0)
    return {k: calls[:1] for k, calls in captured.items()}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("designs", nargs="+", help="NAME=DIR")
    ap.add_argument("--paths", required=True)
    ap.add_argument("--kernels", default="")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from chord_tpu_torch.ops import _cuda, kernels
    from chord_tpu_torch.ops.kernels import PATHS

    smi = chip_smoke.card_line()
    chip_smoke.log(f"card: {smi}")
    dev = torch.device("cuda", 0)
    libs = {}
    for spec in a.designs:
        name, d = spec.split("=", 1)
        csrc = _cuda.CSRC if d == "." else Path(d).resolve() / "csrc"
        chip_smoke.log(f"design {name}: {csrc}")
        libs[name] = ctypes.CDLL(str(_cuda.build(verbose=True, csrc=csrc)))
    home = _cuda.lib()

    paths = a.paths.split(",")
    # the shadow and brick paths reuse geo_tex's scene
    frame_paths = [p for p in PATHS if p in paths or (
        p == "geo_tex" and {"geo_tex_bricks", "geo_shadow_atmo"} & set(paths))]
    scenes = chip_smoke.bench_scenes(dev, frame_paths) if frame_paths else {}
    wanted = set(a.kernels.split(",")) if a.kernels else None
    result = []
    for path in paths:
        captured = capture(path, dev, scenes)
        for k in kernels.KERNELS:
            calls = captured[k.name]
            if not calls or (wanted and k.name not in wanted):
                continue
            for i, (args, kwargs) in enumerate(calls):
                _cuda._lib = home
                entry = entry_point(k, args, kwargs)
                ref = kernels.outputs_list(k.plain(*args, **kwargs))
                names = [n for n, lib in libs.items() if hasattr(lib, entry)]
                fns = []
                for n in names:
                    def run(_lib=libs[n]):
                        _cuda._lib = _lib
                        return k.fn()(*args, **kwargs)
                    err = kernels.max_abs_err(kernels.outputs_list(run()),
                                              ref)
                    if err != 0.0:
                        raise AssertionError(f"design {n}: {k.name} on "
                                             f"{path} #{i} differs by {err}")
                    fns.append(run)
                lib = chip_smoke.library_call(k.name, args)
                if lib:
                    names.append("library")
                    fns.append(lib)
                runs = chip_smoke.alternate(fns, a.rounds, a.reps)
                _cuda._lib = home
                call = f"#{i} " + chip_smoke.describe(k.name, args, kwargs)
                chip_smoke.log(f"ab {k.name} on {path} {call}: " + "; ".join(
                    f"{n} {chip_smoke.spread(r)}"
                    for n, r in zip(names, runs)))
                result.append(dict(kernel=k.name, path=path, call=call,
                                   medians={n: statistics.median(r) for n, r
                                            in zip(names, runs)},
                                   rounds=dict(zip(names, runs))))
    print(json.dumps({"ab": result, "rounds": a.rounds, "reps": a.reps}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
