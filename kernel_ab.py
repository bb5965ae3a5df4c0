#!/usr/bin/env python3
"""Compare designs of the port's CUDA kernels on one GPU, in turns.

    python3 kernel_ab.py NAME=DIR [NAME=DIR ...] --paths P[,P...]
        [--kernels K[,K...]] [--rounds N] [--reps N] [--sass]
        [--inexact NAME[,NAME...]]

Each DIR holds a `csrc/` directory of kernel sources; "." stands for this
checkout (chord_tpu_torch/csrc). The script builds one library per design
(nvcc's -Xptxas -v lines printed under the design's name), captures the
kernel calls of one frame of each frame path (chip_smoke.capture_frame),
of the repro tool's `tm_pallas` first call (path `repro_eval`) or of the
proto tool's first call in main() (path `proto_paged_tex`, K10), with
this checkout's kernels, and then, for each captured call of each kernel
in --kernels (default: every kernel of the paths), for each design whose
library exports the kernel's entry point: runs it against the plain
version (tolerance 0; a mismatch fails the run) and times it. The designs
run in turns, `--rounds` rounds of `--reps` calls each, the order
reversed every other round (chip_smoke.alternate: device time, queued
behind a device-side sleep); a kernel with a library yardstick
(chip_smoke.library_call) has that call in the turns as well. Prints per
call each design's median and the rounds' range, then one JSON line with
every round; the last line is the card's name and power limit.
`--sass` prints, per design, the SASS opcode counts of each kernel
function compiled from the kernels' sources (cuobjdump). `--inexact`
names designs that may differ from the plain version (timing probes that
leave work out, to see where the time goes): they are timed, their
difference is printed, and no committed design may be among them.

A design's library replaces the checkout's for its turn only; the plain
versions and the inputs are this checkout's. So the designs compared must
keep the C entry points' signatures.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import statistics
import subprocess
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


def sass_counts(lib_path: Path, stem: str) -> dict:
    """{function: Counter of SASS opcodes} for the library's kernel
    functions compiled from csrc/<stem>.cu (their mangled names carry the
    source's name)."""
    from chord_tpu_torch.ops import _cuda

    tool = shutil.which("cuobjdump") or str(
        Path(_cuda._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for sec in sass.split("Function : ")[1:]:
        name = sec.split("\n", 1)[0].strip()
        if f"_{stem}_cu_" not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                sec))
        # drop the anonymous namespace's hash and the name's length
        out[re.sub(r"^[0-9a-f]{8}\d+", "",
                   name.split(f"_{stem}_cu_", 1)[1])] = ops
    return out


def capture(path, dev, scenes):
    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.tools import proto_paged_tex, repro_eval_kernel

    if path not in ("repro_eval", "proto_paged_tex"):
        return chip_smoke.capture_frame(path, scenes[path])[0]
    with kernels.capture_inputs() as captured:
        if path == "repro_eval":
            repro_eval_kernel.run_variant("tm_pallas", dev, 0)
        else:
            proto_paged_tex.main(device=dev)
    return {k: calls[:1] for k, calls in captured.items()}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("designs", nargs="+", help="NAME=DIR")
    ap.add_argument("--paths", required=True)
    ap.add_argument("--kernels", default="")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--inexact", default="")
    a = ap.parse_args()
    inexact = set(filter(None, a.inexact.split(",")))
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
        path = _cuda.build(verbose=True, csrc=csrc)
        libs[name] = ctypes.CDLL(str(path))
        if a.sass:
            for k in kernels.KERNELS:
                if a.kernels and k.name not in a.kernels.split(","):
                    continue
                stem = Path(k.source).stem
                for fn, ops in sass_counts(path, stem).items():
                    chip_smoke.log(
                        f"sass {name} {k.name} {fn}: {sum(ops.values())} "
                        "instructions; " + ", ".join(
                            f"{op} {n}" for op, n in ops.most_common(16)))
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
                fns, labels = [], []
                for n in names:
                    def run(_lib=libs[n]):
                        _cuda._lib = _lib
                        return k.fn()(*args, **kwargs)
                    err = kernels.max_abs_err(kernels.outputs_list(run()),
                                              ref)
                    if err != 0.0 and n not in inexact:
                        raise AssertionError(f"design {n}: {k.name} on "
                                             f"{path} #{i} differs by {err}")
                    fns.append(run)
                    labels.append(n if n not in inexact else
                                  f"{n} (inexact probe, differs by {err})")
                lib = chip_smoke.library_call(k.name, args)
                if lib:
                    names.append("library")
                    labels.append("library")
                    fns.append(lib)
                runs = chip_smoke.alternate(fns, a.rounds, a.reps)
                _cuda._lib = home
                call = f"#{i} " + chip_smoke.describe(k.name, args, kwargs)
                chip_smoke.log(f"ab {k.name} on {path} {call}: " + "; ".join(
                    f"{n} {chip_smoke.spread(r)}"
                    for n, r in zip(labels, runs)))
                result.append(dict(kernel=k.name, path=path, call=call,
                                   medians={n: statistics.median(r) for n, r
                                            in zip(names, runs)},
                                   rounds=dict(zip(names, runs))))
    print(json.dumps({"ab": result, "rounds": a.rounds, "reps": a.reps}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
