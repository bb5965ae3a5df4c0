#!/usr/bin/env python3
"""Compare designs of the port's CUDA kernels on one GPU, in turns.

    python3 kernel_ab.py NAME=DIR [NAME=DIR ...] --paths P[,P...]
        [--kernels K[,K...]] [--rounds N] [--reps N] [--sass]
        [--inexact NAME[,NAME...]] [--k4-parent NAME]

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
`--k4-parent NAME` names a design whose library has K4's earlier entry
point, chord_tile_reproject (edge-padded (C, MARGIN+hp+48, MARGIN+wp+256)
planes in, (C, hp, wp) out; the wrapper padded, permuted and cropped
around it): for each tile_reproject call of the paths it times, in turns,
that kernel alone on the padded planes, this checkout's kernel alone and
the earlier wrapper's pad alone, after checking that the earlier whole
call (tile table, pad, kernel, permute and crop, residual) and this
checkout's (tile table, kernel, residual) give the same history and
residual bit for bit; beside them it prints each whole call's device busy
time (busy_ms: the profiler's device events, summed), since a whole call
of some 40 small operations reads the host's gaps between them in
event timing.

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

import torch

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
    """The kernel calls of one frame of the path (or the tool's call), and
    under "k4_public" the (img, motion) of each public tile_reproject call
    among them."""
    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.ops import tile_reproject as tr
    from chord_tpu_torch.tools import proto_paged_tex, repro_eval_kernel

    if path not in ("repro_eval", "proto_paged_tex"):
        public, orig = [], tr.tile_reproject

        def rec(img, motion_px):
            public.append((img, motion_px))
            return orig(img, motion_px)

        tr.tile_reproject = rec     # its callers import it at call time
        try:
            captured = chip_smoke.capture_frame(path, scenes[path])[0]
        finally:
            tr.tile_reproject = orig
        # the captured frame's calls (the warm-up frames' come first)
        n = len(captured["tile_reproject"])
        return dict(captured, k4_public=public[len(public) - n:])
    with kernels.capture_inputs() as captured:
        if path == "repro_eval":
            repro_eval_kernel.run_variant("tm_pallas", dev, 0)
        else:
            proto_paged_tex.main(device=dev)
    return {k: calls[:1] for k, calls in captured.items()}


def parent_k4(lib, planes, tab, hp: int, wp: int):
    """K4's earlier kernel: padded planes (C, ph, pw) -> (C, hp, wp)."""
    from chord_tpu_torch.ops import _cuda

    c, ph, pw = planes.shape
    out = torch.empty((c, hp, wp), dtype=torch.float32, device=planes.device)
    fn = lib.chord_tile_reproject
    fn.restype = ctypes.c_int
    args = (_cuda.ptr(planes), _cuda.ptr(tab), *map(_cuda.cint, (
        c, hp, wp, pw, ph)), _cuda.ptr(out), _cuda.stream())
    fn.argtypes = [type(a) for a in args]
    if fn(*args) != 0:
        raise RuntimeError("chord_tile_reproject: launch failed")
    return out


def parent_k4_planes(img):
    """The earlier wrapper's edge-padded planes of an (h, w, C) history."""
    import torch.nn.functional as F

    from chord_tpu_torch.ops import tile_reproject as tr

    h, w, _ = img.shape
    hp, wp = tr._tiles(h, w)
    return F.pad(img.permute(2, 0, 1)[None],
                 (tr.MARGIN, wp - w + tr.WIN_W, tr.MARGIN,
                  hp - h + tr.WIN_H), mode="replicate")[0].contiguous()


def parent_tile_reproject(lib, img, motion_px):
    """The earlier tile_reproject: table, pad, kernel, permute and crop,
    residual."""
    from chord_tpu_torch.ops import tile_reproject as tr

    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape
    hp, wp = tr._tiles(h, w)
    planes = parent_k4_planes(img)
    tm, tab = tr._tile_table(motion_px, hp, wp)
    out = parent_k4(lib, planes, tab, hp, wp).permute(1, 2, 0)[:h, :w]
    if squeeze:
        out = out[..., 0]
    return out, tr.residual(motion_px, tm)


def busy_ms(fn, reps: int = 20):
    """-> (device ms, device ops) per call: the device events (kernels,
    copies, sets) torch.profiler records over `reps` calls, summed, so
    the host's gaps between them do not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in ev) / 1000 / reps,
            sum(e.count for e in ev) / reps)


def k4_turns(lib, public, path, rounds: int, reps: int) -> list:
    """K4 before and after, each kernel alone and the earlier pad in
    turns, and each whole tile_reproject call's device busy time, on each
    public call -> JSON rows."""
    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.ops import tile_reproject as tr

    rows = []
    for i, (img, mot) in enumerate(public):
        img3 = img if img.dim() == 3 else img[..., None]
        h, w, c = img3.shape
        hp, wp = tr._tiles(h, w)
        tab = tr._tile_table(mot, hp, wp)[1]
        planes = parent_k4_planes(img3)
        new, old = tr.tile_reproject(img, mot), parent_tile_reproject(
            lib, img, mot)
        err = kernels.max_abs_err([new[0], new[1]],
                                  [old[0].contiguous(), old[1]])
        if err != 0.0:
            raise AssertionError(f"K4 before and after differ on {path} "
                                 f"#{i}: {err}")
        fns = {"parent kernel": lambda: parent_k4(lib, planes, tab, hp, wp),
               "new kernel": lambda: tr.reproject_tiles(img3, tab),
               "parent pad": lambda: parent_k4_planes(img3)}
        runs = chip_smoke.alternate(list(fns.values()), rounds, reps)
        busy = {"parent call": busy_ms(
                    lambda: parent_tile_reproject(lib, img, mot)),
                "new call": busy_ms(lambda: tr.tile_reproject(img, mot))}
        out = tr.reproject_tiles(img3, tab)
        bound = chip_smoke.bound("tile_reproject", (img3, tab), {}, out)
        old_bytes = chip_smoke._nbytes([planes, tab, out])
        call = f"#{i} " + chip_smoke.describe("tile_reproject", (img3, tab),
                                              {})
        chip_smoke.log(
            f"ab_k4 on {path} {call}: " + "; ".join(
                f"{n} {chip_smoke.spread(r)}" for n, r in zip(fns, runs)) +
            "; device busy per whole call (profiler): " + ", ".join(
                f"{n} {ms:.5f} ms in {ops:.0f} device ops"
                for n, (ms, ops) in busy.items()) +
            f"; bound {bound[0]:.5f} ms ({bound[1]}: the history pixels "
            f"the taps touch, the table, the output), the earlier bound of "
            f"the padded planes, table and output "
            f"{old_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3:.5f} ms")
        rows.append(dict(kernel="tile_reproject", path=path, call=call,
                         medians={n: statistics.median(r)
                                  for n, r in zip(fns, runs)},
                         rounds=dict(zip(fns, runs)), busy=busy,
                         bound_ms=bound[0],
                         padded_bound_ms=old_bytes /
                         chip_smoke.HBM_BYTES_PER_S * 1e3))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("designs", nargs="+", help="NAME=DIR")
    ap.add_argument("--paths", required=True)
    ap.add_argument("--kernels", default="")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--inexact", default="")
    ap.add_argument("--k4-parent", default="")
    a = ap.parse_args()
    inexact = set(filter(None, a.inexact.split(",")))
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from chord_tpu_torch.ops import _cuda, kernels
    from chord_tpu_torch.ops.kernels import FRAME_PATHS

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
    frame_paths = chip_smoke.scene_paths([p for p in paths
                                          if p in FRAME_PATHS])
    scenes = chip_smoke.bench_scenes(dev, frame_paths) if frame_paths else {}
    wanted = set(a.kernels.split(",")) if a.kernels else None
    result = []
    for path in paths:
        captured = capture(path, dev, scenes)
        if a.k4_parent and captured.get("k4_public"):
            result += k4_turns(libs[a.k4_parent], captured["k4_public"],
                               path, a.rounds, a.reps)
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
