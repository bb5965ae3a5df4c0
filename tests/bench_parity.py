"""Probes of the port against chord_tpu at bench size, on the CPU.

    python tests/bench_parity.py frames off [--goldens DIR] [--frames N]
                                            [--save DIR] [--timeout S]
    python tests/bench_parity.py k2 nanite 0 [--no-fma]
    python tests/bench_parity.py history geo_shadow_atmo --no-fma [--frames N]
    python tests/bench_parity.py split geo_shadow_atmo_split 0 --no-fma
    python3 tests/bench_parity.py dump all_ddgi --device cuda --out DIR
                                       [--frames N] [--keep 0,1,7]
    python tests/bench_parity.py history all_ddgi --no-fma --port-dump DIR
    python tests/bench_parity.py history all_4k --no-fma --window 896,688
    python3 tests/bench_parity.py devdiff all_ddgi 1 --device cuda
                                          [--funcs sp.ggx_sample_normal,...]
    python tests/bench_parity.py ign [--no-fma]
    python tests/bench_parity.py images A.png B.png
    python tests/bench_parity.py rays all_exact [--check]
    python tests/bench_parity.py specular all_4k 6 --no-fma [--frames 8]
                                 [--texel 75,56] [--out DIR] [--reference DIR]
                                 [--extra shading.resolve_gbuffer_raster_rt]

`frames`: the port's plain path renders a bench_goldens cell frame by
frame (chip_smoke's scene, configs and history, on the CPU) and each
frame's stats, and the kept frames' SSIM / MAE / worst window, are held to
a goldens directory's manifest (default tests/goldens/bench; a
`bench_goldens.py CELL --fma --out DIR` render for XLA's default build);
`--save DIR` writes the port's kept frames there as PNGs. A strip cell
(`sharded_all`, `sharded_flat`) renders through render_strips on two gloo
CPU ranks (spawn_strips, deadline `--timeout`, default 4 h): its summed
stats and rank 0's gathered image.

`k2`: the mesh-shader setup of one frame of a cell. chord_tpu renders
frames 0..FRAME (jitted, interpret mode) and records each
mesh_shader_setup call's draws, per-draw matrices and validity; the port
renders the same frames and records its K2 inputs. Per call: whether the
draws and the matrices are equal, the valid triangles of each, and then
chord_tpu's Pallas kernel (unsorted) and the port's plain K2 on the port's
own inputs, lane by lane: the flipped triangles with their tests in
float64 (screen bbox, the pixel centres it covers, the determinant and
its share of the corner product), and the plane values that differ.
Cells without shadows only: chord_tpu renders a cascade inside a
lax.switch, where the recorder cannot reach.

`history`: chord_tpu (jitted, interpret mode; --no-fma as the goldens)
and the port render a cell's frames side by side (the split: each frame
and then its shadow service), and after each frame the histories' depth
range, cascade matrices, shadow maps (per cascade), shadow mask,
exposure and TSR colour are compared, and with GI on the world cache
(per cascade), the screen-probe planes and the diffuse and specular
histories, or DDGI's irradiance, distance, SH, offset and weight (per
cascade), with the image gates of the frame; `--window ROW,COLUMN`
then reports that 16x16 output window: its pixels, each image-like
leaf's difference over the same region and the port's G-buffer there.

`dump` (no JAX: for the card): the port's frames of a cell on a device,
each kept frame's image and history leaves written to DIR; `history
--port-dump DIR` then holds them to chord_tpu's frames here.

`devdiff` (no JAX: for the card): in one frame of a cell rendered on a
device, each call of the named functions (default the specular GI chain)
rerun on the CPU on copies of its inputs, outputs compared.

`specular`: the specular GI chain (SPECULAR_CHAIN: the dilated motion,
the GGX sample, the cache radiance, SSR's march, the BVH rays on its
misses and their shading, the firefly clamp, the spatial and temporal
filters) of frame FRAME, chord_tpu (jitted, interpret mode) beside the
port's CPU frames 0..FRAME (--frames N: 0..N-1); after every frame the
gi_specular texels that differ by more than 1e-5; in frame FRAME each
call in both packages, its inputs and outputs compared, the port's
function rerun on chord_tpu's own inputs (a function that differs told
apart from inputs that differ), and at --texel (the 180x320 plane's
(75, 56) at 4K by default) the values and each discrete decision's
operands in both. `--out DIR` keeps chord_tpu's side; `--reference DIR`
reads it back (the port alone); `--extra module.function,...` records
more of the frame's ops functions (a NamedTuple output field by field).

`split`: the split's shadow service pass by pass (PCSS evaluate, phase
expand, temporal blend) of one frame, the port's on chord_tpu's own
split dict, history and refreshed cascades, each output against
chord_tpu's.

`ign`: jitted chord_tpu interleaved-gradient noise against the port's
eager one at 720x1280 and 180x320.

`images`: chip_smoke's SSIM, MAE and worst window of two PNGs.

`rays`: the inputs of each rt.trace call of the port's CPU frame 0 of a
path (all_exact: RTAO's four calls, the probe rays, SSR's misses), 4,096
rays a call chosen with a seed, and for RTAO's and the specular GI's
calls what their directions are made of (the kept pixels of the call's
plane, their G-buffer values, the frame count), written to the goldens
directory (<path>_rays.npz) for `bench_goldens.py <path>_rays` to make
those directions and trace the rays through chord_tpu; `--check` holds
the port's CPU directions and traces of them, over its own BVH of the
path, to that golden (the BVH's hashes, the directions, leaf and t bit
for bit), as chip_smoke's phase 13 does on the card.

`--no-fma` compiles chord_tpu with XLA_FLAGS=--xla_cpu_max_isa=SSE4_2
(no fused multiply-adds), as tests/bench_goldens.py does; without it
XLA's default CPU build contracts a*b+c. JAX_PLATFORMS=cpu is set here.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _port_cell(cell: str):
    """chip_smoke's scene, configs and fresh history of a cell, on the CPU."""
    import torch

    import chip_smoke as cs

    d = torch.device("cpu")
    scene = cs.bench_scenes(d, cs.scene_paths([cell]))[cell]
    config, mcfg = cs.configs(cell, scene[3])
    return scene, config, mcfg, cs.history(config, mcfg, d)


def frames(cell: str, goldens: str, n: int | None,
           save: str | None = None, timeout_s: float = 14400.0) -> None:
    import chip_smoke as cs

    with open(os.path.join(goldens, "manifest.json")) as f:
        rec = json.load(f)["cells"][cell]
    n = n or rec["frames_rendered"]
    if cell in cs.SHARDED_FROM:
        strip_frames(cell, rec, goldens, n, save, timeout_s)
        return
    scene, config, mcfg, hist = _port_cell(cell)
    for i in range(n):
        t0 = time.time()
        img, hist, st = cs.run_path(cell, scene, config, mcfg, hist, i, i + 1)
        _frame_line(cell, i, {k: int(v[0]) for k, v in st.items()},
                    img[0].numpy(), rec, goldens, save,
                    f"{time.time() - t0:.1f} s")


def strip_frames(cell: str, rec: dict, goldens: str, n: int,
                 save: str | None, timeout_s: float) -> None:
    """`frames` of a strip cell: chip_smoke's strip job (its host scene
    on the CPU) for frames 0..n-1, rendered by render_strips on
    STRIP_RANKS gloo CPU ranks (spawn_strips, with a deadline of
    `timeout_s`), each frame's summed stats and rank 0's gathered image
    held to the goldens."""
    import torch

    import chip_smoke as cs
    from chord_tpu_torch.parallel.sharded import render_strips, spawn_strips

    d = torch.device("cpu")
    t0 = time.time()
    scenes = cs.bench_scenes(d, cs.scene_paths([cs.SHARDED_FROM[cell]]))
    job = cs.strip_job(cell, scenes)
    del scenes
    insts = job.instances
    job = job._replace(uniforms=list(job.uniforms[:n]),
                       instances=(insts[:n] if isinstance(insts, list)
                                  else insts))
    print(f"{cell}: the strip job's host scene in {time.time() - t0:.1f} s",
          flush=True)
    t0 = time.time()
    ranks = spawn_strips(cs.STRIP_RANKS, render_strips, job, device="cpu",
                         timeout_s=timeout_s)
    per = f"{(time.time() - t0) / n:.1f} s a frame"
    for i, fr in enumerate(ranks[0]):
        _frame_line(cell, i, {k: int(v) for k, v in fr["stats"].items()
                              if np.ndim(v) == 0},
                    fr["image"], rec, goldens, save, per)


def _frame_line(cell: str, i: int, st: dict, img, rec: dict, goldens: str,
                save: str | None, took: str) -> None:
    """Print frame i's stats against the manifest's and, on a kept frame,
    its image gates against the golden PNG (the image saved to `save`)."""
    import chip_smoke as cs

    ref = rec["stats"][i]
    diff = {k: (st[k], ref[k]) for k in st if k in ref and st[k] != ref[k]}
    line = (f"{cell} frame {i} ({took}): stats "
            f"{'equal' if not diff else f'differ (port, chord_tpu) {diff}'}")
    if str(i) in rec["images"]:
        g = cs.image_gates(img, cs.read_png(
            os.path.join(goldens, rec["images"][str(i)])))
        line += f"; image {json.dumps(g)}"
        if save:
            from PIL import Image

            os.makedirs(save, exist_ok=True)
            Image.fromarray(img).save(
                os.path.join(save, f"port_{cell}_f{i:02d}.png"))
    print(line, flush=True)


def _diff(a, b) -> str:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    where = np.unravel_index(int(d.argmax()), d.shape)
    return (f"max {d.max():.3g} at {tuple(int(v) for v in where)}, "
            f"{float((d > 0).mean()):.2e} differ")


# the history leaves `history` compares (those the cell's config fills)
HISTORY_LEAVES = ("depth_range", "shadow_mats", "shadow_maps", "shadow_mask",
                  "exposure", "tsr_color", "gi_cache", "probe_sh",
                  "gi_diffuse", "gi_specular", "ddgi.irr", "ddgi.dist",
                  "ddgi.sh", "ddgi.offset", "ddgi.weight")


def _leaves(hist) -> dict:
    """HISTORY_LEAVES of a history (the port's or chord_tpu's) as numpy,
    without those that are all zero (off, or not yet written)."""
    out = {}
    for name in HISTORY_LEAVES:
        a = hist
        for part in name.split("."):
            a = getattr(a, part, None)
        if a is None:
            continue
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        if a.any():
            out[name] = a
    return out


def dump(cell: str, n: int | None, device: str, out: str, keep) -> None:
    """The port's frames 0..n-1 of a cell on `device` (chip_smoke's scene,
    configs and history, one frame a run_path call); after each frame in
    `keep`, its image and history leaves (HISTORY_LEAVES but the shadow
    maps and the TSR colour, tens of MB a frame) go to OUT/frame_NN.npz,
    for `history --port-dump OUT`. A strip cell runs its STRIP_RANKS
    ranks (spawn_strips; strip_dump_rank writes every frame's image and
    the kept frames' leaves per rank). Imports no JAX: it runs where the
    card is."""
    import torch

    import chip_smoke as cs

    d = torch.device(device)
    os.makedirs(out, exist_ok=True)
    if cell in cs.SHARDED_FROM:
        from chord_tpu_torch.parallel.sharded import spawn_strips

        job = cs.strip_job(cell, cs.bench_scenes(
            d, cs.scene_paths([cs.SHARDED_FROM[cell]])))
        insts = job.instances
        job = job._replace(uniforms=list(job.uniforms[:n or 8]),
                           instances=(insts[:n or 8] if isinstance(
                               insts, list) else insts))
        spawn_strips(cs.STRIP_RANKS, strip_dump_rank, job, out, keep,
                     device="cpu" if d.type == "cpu" else None,
                     timeout_s=3600)
        return
    scene = cs.bench_scenes(d, cs.scene_paths([cell]))[cell]
    config, mcfg = cs.configs(cell, scene[3])
    hist = cs.history(config, mcfg, d)
    for i in range(n or 8):
        img, hist, _ = cs.run_path(cell, scene, config, mcfg, hist, i, i + 1)
        if keep is None or i in keep:
            leaves = {k: v for k, v in _leaves(hist).items()
                      if k not in ("shadow_maps", "tsr_color")}
            np.savez_compressed(os.path.join(out, f"frame_{i:02d}.npz"),
                                image=img[0].cpu().numpy(), **leaves)
        print(f"{cell} frame {i} on {device}: dumped "
              f"{keep is None or i in keep}", flush=True)


def strip_dump_rank(rank: int, device, job, out: str, keep) -> None:
    """A rank of `dump` on a strip cell (spawn_strips' function; this
    module imports no JAX): the job's frames through ShardedRenderer;
    after each frame rank 0 writes the gathered image to
    OUT/frame_NN.npz and, on a frame in `keep` (None: every frame), each
    rank its strip's history leaves (as `dump`) to
    OUT/frame_NN_rankR.npz."""
    from chord_tpu_torch.parallel.sharded import ShardedRenderer, load_job

    r = ShardedRenderer(job.config, path=job.path, mcfg=job.mcfg,
                        device=device)
    pools, insts, bvh, luts = load_job(job, device)
    for i, (u, inst) in enumerate(zip(job.uniforms, insts)):
        img, _ = r.render(pools, inst, u, bvh=bvh, luts=luts,
                          **(job.light_kwargs or {}))
        if rank == 0:
            np.savez_compressed(os.path.join(out, f"frame_{i:02d}.npz"),
                                image=img.numpy())
        if keep is None or i in keep:
            leaves = {k: v for k, v in _leaves(r.history).items()
                      if k not in ("shadow_maps", "tsr_color")}
            np.savez_compressed(
                os.path.join(out, f"frame_{i:02d}_rank{rank}.npz"), **leaves)
        print(f"strip {rank} frame {i} on {device}: dumped", flush=True)


# the resolve's per-object motion delta, the DDGI update and the specular
# GI chain, as renderer/meshlet_frame.py names them (module
# alias.function): devdiff's default
DEVDIFF_FUNCS = ("shading.motion_delta", "ddgi_ops.ddgi_update",
                 "mf.interleaved_gradient_noise",
                 "sp.ggx_sample_normal",
                 "gi_ops.sample_radiance", "ssr_ops.trace", "rt.trace",
                 "rt.shade_hits", "sp.specular_firefly_clamp",
                 "sp.spatial_filter_specular", "sp.temporal_specular")


def _to(x, device):
    """Tensors (in tuples, lists, dicts, NamedTuples and dataclasses, as
    the frame's pools and instance tables) copied to `device`; anything
    else as it is."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


def _tensors(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def devdiff(cell: str, frame: int, device: str, funcs,
            save: str | None = None) -> None:
    """Device against CPU, function by function (no JAX: for the card):
    the port renders frames 0..FRAME of a cell on `device`; in frame FRAME
    every call of `funcs` (DEVDIFF_FUNCS by default: the DDGI update and
    the specular chain) is
    recorded with its inputs and outputs, then rerun on CPU copies of its
    inputs, and each output is compared: a function whose device result
    differs from its CPU result on the same inputs is where the two
    devices part. A strip cell records on every rank
    (strip_devdiff_rank); `save` DIR then receives each rank's recorded
    outputs (DIR/devdiff_rankR.npz, `NN_function_outJ`), to hold one
    device's run against another's."""
    import torch

    import chip_smoke as cs

    d = torch.device(device)
    if cell in cs.SHARDED_FROM:
        from chord_tpu_torch.parallel.sharded import spawn_strips

        job = cs.strip_job(cell, cs.bench_scenes(
            d, cs.scene_paths([cs.SHARDED_FROM[cell]])))
        job = job._replace(uniforms=list(job.uniforms[:frame + 1]))
        ranks = spawn_strips(cs.STRIP_RANKS, strip_devdiff_rank, job, frame,
                             funcs, save, device="cpu" if d.type == "cpu"
                             else None, timeout_s=3600)
        for rank, lines in enumerate(ranks):
            print(f"{cell} strip {rank} frame {frame}: {len(lines)} "
                  f"outputs, {device} against the CPU on the same inputs")
            print("\n".join(lines), flush=True)
        return
    scene = cs.bench_scenes(d, cs.scene_paths([cell]))[cell]
    config, mcfg = cs.configs(cell, scene[3])
    hist = cs.history(config, mcfg, d)
    if frame:
        hist = cs.run_path(cell, scene, config, mcfg, hist, 0, frame)[1]
    calls = []
    with _recording(funcs, calls):
        cs.run_path(cell, scene, config, mcfg, hist, frame, frame + 1)
    print(f"{cell} frame {frame}: {len(calls)} calls, {device} against the "
          "CPU on the same inputs", flush=True)
    for line in _rerun(calls):
        print(line, flush=True)


@contextlib.contextmanager
def _recording(funcs, calls: list):
    """Inside: every call of `funcs` (renderer/meshlet_frame.py's module
    alias.function) appends (name, function, CPU copies of its inputs, of
    its outputs) to `calls`."""
    from chord_tpu_torch.renderer import meshlet_frame as mf

    saved = []
    for name in funcs:
        alias, fn = name.split(".")
        owner = mf if alias == "mf" else getattr(mf, alias)
        f = getattr(owner, fn)
        saved.append((owner, fn, f))

        @functools.wraps(f)     # keeps the function's counters
        def wrapped(*a, _f=f, _n=name, **kw):
            out = _f(*a, **kw)
            calls.append((_n, _f, _to(a, "cpu"), _to(kw, "cpu"),
                          _to(out, "cpu")))
            return out
        setattr(owner, fn, wrapped)
    try:
        yield
    finally:
        for owner, fn, f in saved:
            setattr(owner, fn, f)


def _rerun(calls) -> list:
    """Each recorded call rerun on its CPU inputs: a line per output, the
    recorded output against the rerun's."""
    lines = []
    for name, f, a, kw, out in calls:
        ref = f(*a, **kw)
        for j, (x, y) in enumerate(zip(_tensors(out), _tensors(ref))):
            where = "" if y.device.type == "cpu" else f" (rerun on {y.device})"
            x, y = x.numpy(), y.cpu().numpy()
            if x.dtype == bool:
                x, y = x.astype(np.int8), y.astype(np.int8)
            lines.append(f"  {name} out {j} {x.shape} {_diff(x, y)}{where}")
    return lines


def strip_devdiff_rank(rank: int, device, job, frame: int, funcs,
                       save: str | None = None) -> list:
    """A rank of `devdiff` on a strip cell (spawn_strips' function): the
    job's frames through ShardedRenderer, `funcs` recorded in frame FRAME
    (their outputs written to SAVE/devdiff_rankR.npz) and rerun on the
    CPU -> the comparison's lines."""
    from chord_tpu_torch.parallel.sharded import ShardedRenderer, load_job

    r = ShardedRenderer(job.config, path=job.path, mcfg=job.mcfg,
                        device=device)
    pools, insts, bvh, luts = load_job(job, device)
    calls = []
    for i, (u, inst) in enumerate(zip(job.uniforms, insts)):
        with _recording(funcs if i == frame else (), calls):
            r.render(pools, inst, u, bvh=bvh, luts=luts,
                     **(job.light_kwargs or {}))
    if save:
        os.makedirs(save, exist_ok=True)
        np.savez_compressed(
            os.path.join(save, f"devdiff_rank{rank}.npz"),
            **{f"{n:02d}_{name}_out{j}": x.numpy()
               for n, (name, _, _, _, out) in enumerate(calls)
               for j, x in enumerate(_tensors(out))})
    return _rerun(calls)


def _window_report(img, ref_img, port: dict, ref: dict, window,
                   gbuf) -> None:
    """What lies in the 16x16 output window at `window` (row, column): the
    image's levels there, each image-like history leaf's difference over
    the same region at its own size, and the port's surface there (the
    G-buffer of the frame: base colour, roughness, metallic)."""
    r, c = window
    ph, pw = img.shape[:2]
    d = np.abs(img.astype(int) - np.asarray(ref_img).astype(int)).max(-1)
    box = d[r:r + 16, c:c + 16]
    print(f"  window ({r}, {c}): {int((box > 0).sum())} of 256 pixels "
          f"differ, by up to {int(box.max())} levels; the image "
          f"{int((d > 0).sum())} pixels", flush=True)
    for name in HISTORY_LEAVES:
        a, b = port.get(name), ref.get(name)
        if a is None or b is None or a.ndim < 2 or name in (
                "shadow_maps", "gi_cache", "shadow_mats"):
            continue
        sy, sx = a.shape[0] / ph, a.shape[1] / pw
        ys = slice(int(r * sy), max(int(np.ceil((r + 16) * sy)), 1))
        xs = slice(int(c * sx), max(int(np.ceil((c + 16) * sx)), 1))
        print(f"  window in {name} {a.shape} rows {ys.start}-{ys.stop} "
              f"columns {xs.start}-{xs.stop}: "
              f"{_diff(a[ys, xs], b[ys, xs])}", flush=True)
    if gbuf is not None:
        gh, gw = gbuf.valid.shape
        ys = slice(int(r * gh / ph), int(np.ceil((r + 16) * gh / ph)))
        xs = slice(int(c * gw / pw), int(np.ceil((c + 16) * gw / pw)))
        for f in ("valid", "base_color", "roughness", "metallic", "normal"):
            v = getattr(gbuf, f)[ys, xs].float().numpy()
            v = v.reshape(-1, v.shape[-1]) if v.ndim == 3 else v.reshape(-1)
            print(f"  the port's {f} over render rows {ys.start}-{ys.stop} "
                  f"columns {xs.start}-{xs.stop}: min {v.min(0)}, max "
                  f"{v.max(0)}, mean {v.mean(0)}", flush=True)


def history(cell: str, n: int | None, port_dump: str | None = None,
            window=None) -> None:
    import bench_goldens as bg
    import chip_smoke as cs

    c = bg.setup_cell(cell)
    jhist = c["hist"]
    gbufs = []
    if port_dump is None:
        scene, config, mcfg, hist = _port_cell(cell)
        if window is not None:
            from chord_tpu_torch.ops import shading

            resolve = shading.resolve_gbuffer_raster_rt

            @functools.wraps(resolve)
            def kept(*a, **k):
                gbufs[:] = [resolve(*a, **k)]
                return gbufs[0]
            shading.resolve_gbuffer_raster_rt = kept
    for i in range(n or 8):
        jimg, jhist, _ = c["step"](i, jhist)
        if port_dump is None:
            img, hist, _ = cs.run_path(cell, scene, config, mcfg, hist, i,
                                       i + 1)
            img, port = img[0].numpy(), _leaves(hist)
        else:
            path = os.path.join(port_dump, f"frame_{i:02d}.npz")
            if not os.path.exists(path):
                continue
            with np.load(path) as z:
                port = {k: z[k] for k in z.files}
            img = port.pop("image")
        g = cs.image_gates(img, np.asarray(jimg))
        print(f"{cell} frame {i}: image {json.dumps(g)}", flush=True)
        ref = _leaves(jhist)
        for name in HISTORY_LEAVES:
            if name not in port and name not in ref:
                continue
            a, b = port.get(name), ref.get(name)
            if a is None or b is None:
                print(f"  {name} only in "
                      f"{'chord_tpu' if a is None else 'the port'}")
                continue
            if name in ("shadow_maps", "gi_cache") or name.startswith(
                    "ddgi."):
                for k in range(a.shape[0]):     # per cascade
                    print(f"  {name}[{k}] {_diff(a[k], b[k])}", flush=True)
            else:
                print(f"  {name} {a.shape} {_diff(a, b)}", flush=True)
        if window is not None:
            _window_report(img, jimg, port, ref, window,
                           gbufs[0] if gbufs else None)


# the specular GI chain (chord_tpu meshlet_frame.py:963-1044) and the
# dilated motion that feeds its history fetch, in the frame's order:
# (chord_tpu's ops module, the port's meshlet_frame alias, function)
SPECULAR_CHAIN = (("post", "post", "tsr_prepare"),
                  ("screen_probe", "sp", "ggx_sample_normal"),
                  ("gi", "gi_ops", "sample_radiance"),
                  ("ssr", "ssr_ops", "trace"),
                  ("rt", "rt", "trace"),
                  ("rt", "rt", "shade_hits"),
                  ("screen_probe", "sp", "specular_firefly_clamp"),
                  ("screen_probe", "sp", "spatial_filter_specular"),
                  ("screen_probe", "sp", "temporal_specular"))
SPECULAR_TOL = 1e-5     # a gi_specular texel differs beyond this


def _named_arrays(f, a, kw) -> dict:
    """A call's array arguments by parameter name (a NamedTuple's arrays
    as name.field), for either package."""
    import inspect

    out = {}
    for name, v in inspect.signature(f).bind(*a, **kw).arguments.items():
        for key, x in ([(f"{name}.{k}", getattr(v, k)) for k in v._fields]
                       if hasattr(v, "_fields") else [(name, v)]):
            if hasattr(x, "shape") and hasattr(x, "dtype"):
                out[key] = x
    return out


def _named_outputs(out) -> dict:
    """A call's outputs: out0, out1, ... (a NamedTuple's arrays as
    out.field)."""
    if hasattr(out, "_fields"):
        return {f"out.{k}": getattr(out, k) for k in out._fields
                if hasattr(getattr(out, k), "shape")}
    outs = out if isinstance(out, tuple) else (out,)
    return {f"out{j}": x for j, x in enumerate(outs)}


@contextlib.contextmanager
def _jax_chain_recording(record: list, chain=SPECULAR_CHAIN):
    """Inside: every call of chord_tpu's `chain` functions (inside a trace
    too) appends (label, its arrays by name, its outputs) to `record`; the
    label is the port's alias.function."""
    import importlib

    saved = []
    for mod, alias, fn in chain:
        owner = importlib.import_module(f"chord_tpu.ops.{mod}")
        f = getattr(owner, fn)
        saved.append((owner, fn, f))

        @functools.wraps(f)
        def wrapped(*a, _f=f, _n=f"{alias}.{fn}", **kw):
            out = _f(*a, **kw)
            record.append((_n, _named_arrays(_f, a, kw), _named_outputs(out)))
            return out
        setattr(owner, fn, wrapped)
    try:
        yield
    finally:
        for owner, fn, f in saved:
            setattr(owner, fn, f)


def _np_record(calls) -> list:
    return [(n, {k: np.asarray(v) for k, v in a.items()},
             {k: np.asarray(v) for k, v in o.items()}) for n, a, o in calls]


def _pair_calls(jcalls, pcalls, chain=SPECULAR_CHAIN) -> list:
    """(label, chord_tpu's call, the port's call) for each label of the
    chain, its calls paired from the last (sample_radiance and rt.trace
    also serve the diffuse probes, earlier in the frame)."""
    pairs = []
    for _, alias, fn in chain:
        label = f"{alias}.{fn}"
        js = [c for c in jcalls if c[0] == label]
        ps = [c for c in pcalls if c[0] == label]
        k = min(len(js), len(ps))
        pairs += [(label, j, p) for j, p in zip(js[len(js) - k:],
                                                ps[len(ps) - k:])]
    return pairs


def _at(x, texel, plane):
    """x at the texel when its leading dims are the specular plane's."""
    if x.ndim >= 2 and tuple(x.shape[:2]) == plane:
        return np.asarray(x[texel[0], texel[1]], np.float64)
    return None


def _fmt(a) -> str:
    return "[" + ", ".join(f"{float(v):.9g}" for v in np.ravel(a)) + "]"


def _texel_line(what, j, p, texel, plane) -> str | None:
    a, b = _at(j, texel, plane), _at(p, texel, plane)
    if a is None:
        return None
    return (f"    {what} at {texel}: chord_tpu {_fmt(a)}, port {_fmt(b)}, "
            f"|d| {np.abs(a - b).max():.3g}")


def _rerun_on(pf, pa, pkw, jarrays):
    """The port's function on chord_tpu's recorded arrays: the port's own
    bound call with each array argument that chord_tpu's call has at the
    same name and shape replaced by chord_tpu's values."""
    import inspect

    import torch

    bound = inspect.signature(pf).bind(*pa, **pkw)
    for name, v in list(bound.arguments.items()):
        if hasattr(v, "_fields"):
            rep = {}
            for k in v._fields:
                x, y = getattr(v, k), jarrays.get(f"{name}.{k}")
                if isinstance(x, torch.Tensor) and y is not None and \
                        tuple(y.shape) == tuple(x.shape):
                    rep[k] = torch.from_numpy(np.array(y)).to(x.dtype)
            bound.arguments[name] = v._replace(**rep)
        elif isinstance(v, torch.Tensor) and name in jarrays and tuple(
                jarrays[name].shape) == tuple(v.shape):
            bound.arguments[name] = torch.from_numpy(
                np.array(jarrays[name])).to(v.dtype)
    return _named_outputs(pf(*bound.args, **bound.kwargs))


def _decisions(pairs, texel, plane) -> None:
    """The chain's discrete decisions at the texel, each computed in
    float64 from either package's recorded operands."""
    import torch

    from chord_tpu_torch.ops import gi as tgi
    from chord_tpu_torch.ops import screen_probe as tsp

    r, c = texel
    f64 = lambda x: np.asarray(x, np.float64)
    for label, (_, ja, jo), (_, pf, pa, pkw, po) in pairs:
        pn = {k: np.asarray(v) for k, v in _named_arrays(pf, pa, pkw).items()}
        if label == "sp.ggx_sample_normal":
            for who, a, h in (("chord_tpu", ja, jo["out0"]),
                              ("port", pn, np.asarray(po["out0"]))):
                n, v, h = (f64(x[r, c]) for x in (a["nrm"], a["view"], h))
                d = 2.0 * (v @ h) * h - v
                took = "normal" if np.allclose(h, n) else "sample"
                print(f"    GGX ok (d.n > 1e-3): {who} d.n {d @ n:.9g}, "
                      f"uses the {took}", flush=True)
        elif label == "gi_ops.sample_radiance":
            cfg = pa[4] if len(pa) > 4 else pkw["cfg"]
            for who, pos in (("chord_tpu", ja["pos_w"]),
                             ("port", pn["pos_w"])):
                p = torch.from_numpy(np.array(pos[r, c]))[None]
                cells = []
                for k in range(cfg.cascades):
                    g, inb = tgi._probe_coords(p, k, cfg, torch.zeros(3))
                    cells.append(f"c{k} g+0.5 {_fmt(f64(g[0]) + 0.5)} in "
                                 f"{bool(inb[0])}")
                print(f"    cache cell pick floor(g + 0.5), {who}: "
                      + "; ".join(cells), flush=True)
        elif label == "sp.specular_firefly_clamp":
            for who, a in (("chord_tpu", ja), ("port", pn)):
                pos = torch.from_numpy(np.array(a["pos_q"]))
                nrm = torch.from_numpy(np.array(a["nrm_q"]))
                wacc = sum(tsp._edge_weights(
                    pos, nrm, [(dy, dx) for s in (1, 2) for dy, dx in
                               ((0, s), (0, -s), (s, 0), (-s, 0))]))
                print(f"    firefly wacc > 1e-5 (the port's weights on "
                      f"{who}'s inputs): {float(wacc[r, c]):.9g}", flush=True)
        elif label == "sp.temporal_specular":
            for who, m in (("chord_tpu", ja["motion_q"]),
                           ("port", pn["motion_q"])):
                mh, mw = m.shape[:2]
                px = np.float32(c + 0.5) - m[r, c, 0] * np.float32(mw) * \
                    np.float32(0.5)
                py = np.float32(r + 0.5) + m[r, c, 1] * np.float32(mh) * \
                    np.float32(0.5)
                print(f"    history fetch trunc(x), trunc(y): {who} motion "
                      f"{_fmt(m[r, c])}, x {px:.9g} y {py:.9g} -> "
                      f"({int(py)}, {int(px)})", flush=True)


def _specular_report(jcalls, pcalls, texel, chain=SPECULAR_CHAIN) -> None:
    """Function by function: where the port's inputs first differ from
    chord_tpu's, its outputs, and the port's function rerun on chord_tpu's
    own inputs (a function that differs, told apart from inputs that
    differ); at the texel the values and the decisions."""
    pairs = _pair_calls(jcalls, pcalls, chain)
    plane = None
    for label, j, _ in pairs:
        if label == "sp.temporal_specular":
            plane = tuple(j[1]["spec"].shape[:2])
    first = None
    for label, (_, ja, jo), (_, pf, pa, pkw, po) in pairs:
        pa_named = _named_arrays(pf, pa, pkw)
        print(f"  {label}", flush=True)
        for name in ja:
            if name not in pa_named or tuple(ja[name].shape) != tuple(
                    pa_named[name].shape):
                continue
            x = pa_named[name].numpy()
            y = ja[name]
            if x.dtype == bool:
                x, y = x.astype(np.int8), y.astype(np.int8)
            print(f"    in {name} {tuple(y.shape)} {_diff(x, y)}", flush=True)
            if texel is not None and plane is not None:
                line = _texel_line(f"in {name}", y, x, texel, plane)
                if line:
                    print(line, flush=True)
        po = _named_outputs(po) if not isinstance(po, dict) else po
        rerun = _rerun_on(pf, pa, pkw, ja)
        for k, y in jo.items():
            x, z = po[k].numpy(), rerun[k].numpy()
            if y.dtype == bool:
                x, y, z = (v.astype(np.int8) for v in (x, y, z))
            print(f"    {k} {tuple(y.shape)} {_diff(x, y)}; on chord_tpu's "
                  f"inputs {_diff(z, y)}", flush=True)
            if texel is not None and plane is not None:
                for what, v in ((k, x), (f"{k} on chord_tpu's inputs", z)):
                    line = _texel_line(what, y, v, texel, plane)
                    if line:
                        print(line, flush=True)
                a = _at(y, texel, plane)
                if a is not None and first is None and np.abs(
                        a - _at(x, texel, plane)).max() > 1e-4:
                    first = (label, k, np.abs(a - _at(z, texel, plane)).max())
    if texel is not None and plane is not None:
        _decisions(pairs, texel, plane)
        if first is None:
            print(f"  at {texel} no output of the chain differs by more than "
                  "1e-4", flush=True)
        else:
            print(f"  at {texel} the first output that differs by more than "
                  f"1e-4: {first[0]} {first[1]}; on chord_tpu's own inputs "
                  f"it differs by {first[2]:.3g}", flush=True)


def specular(cell: str, frame: int, n: int | None, texel, out: str | None,
             reference: str | None, extra=()) -> None:
    """The specular GI chain of one frame, in both packages: chord_tpu
    (jitted, interpret mode; --no-fma as the goldens) and the port's CPU
    path render frames 0..n-1 (default FRAME); after each frame, the
    gi_specular texels that differ from chord_tpu's by more than
    SPECULAR_TOL; in frame FRAME each call of SPECULAR_CHAIN is recorded
    in both and reported by _specular_report. `out` DIR keeps chord_tpu's
    side (every frame's gi_specular, the recorded calls) and the port's
    recorded calls as npz; `reference` DIR reads chord_tpu's side from
    such a directory instead of rendering it (the port alone). `extra`
    functions (ops module.function, as "shading.resolve_gbuffer_raster_rt")
    are recorded and reported before the chain."""
    import chip_smoke as cs

    chain = tuple(tuple([f.split(".")[0]] + f.split(".")) for f in extra) \
        + SPECULAR_CHAIN
    n = n or frame + 1
    scene, config, mcfg, hist = _port_cell(cell)
    if reference is None:
        import jax

        import bench_goldens as bg
        from chord_tpu.renderer.meshlet_frame import render_frame_meshlet

        c = bg.setup_cell(cell)
        if "strips" in bg.CELLS.get(cell, {}) or cell == cs.SPLIT:
            raise SystemExit("specular steps one-process frames only")
        record, labels = [], []

        def frame_fn(pools, inst, view, h):
            record.clear()
            img, h, _ = render_frame_meshlet(pools, inst, view, h,
                                             config=c["config"],
                                             mcfg=c["mcfg"], bvh=c["bvh"])
            labels[:] = [r[0] for r in record]
            return img, h, [(r[1], r[2]) for r in record]
        fn = jax.jit(frame_fn)
        jhist = c["hist"]
    if out:
        os.makedirs(out, exist_ok=True)
    for i in range(n):
        t0 = time.time()
        if reference is None:
            with _jax_chain_recording(record, chain):
                _, jhist, rec = fn(c["pools"], c["inst"], c["views"][i],
                                   jhist)
            jspec = np.asarray(jhist.gi_specular)
            jcalls = (_np_record([(lab, a, o) for lab, (a, o) in
                                  zip(labels, rec)]) if i == frame else None)
            if out:
                np.save(os.path.join(out, f"jax_gi_specular_f{i:02d}.npy"),
                        jspec)
                if jcalls is not None:
                    np.savez(os.path.join(out, f"jax_calls_f{i:02d}.npz"),
                             **_flat_calls(jcalls))
        else:
            jspec = np.load(os.path.join(reference,
                                         f"jax_gi_specular_f{i:02d}.npy"))
            jcalls = (_unflat_calls(np.load(os.path.join(
                reference, f"jax_calls_f{i:02d}.npz")))
                if i == frame else None)
        pcalls = []
        with _recording([f"{a}.{f}" for _, a, f in chain]
                        if i == frame else (), pcalls):
            _, hist, _ = cs.run_path(cell, scene, config, mcfg, hist, i,
                                     i + 1)
        pcalls = [(nm, f, a, kw, _named_outputs(o))
                  for nm, f, a, kw, o in pcalls]
        pspec = hist.gi_specular.numpy()
        d = np.abs(pspec.astype(np.float64) - jspec).max(-1)
        where = np.argwhere(d > SPECULAR_TOL)
        print(f"{cell} frame {i}: gi_specular {pspec.shape[:2]} texels that "
              f"differ by more than {SPECULAR_TOL:g}: {len(where)} "
              f"{[tuple(int(v) for v in w) for w in where[:8]]}, max "
              f"{d.max():.3g} ({time.time() - t0:.1f} s)", flush=True)
        if i != frame:
            continue
        if out:
            np.savez(os.path.join(out, f"port_calls_f{i:02d}.npz"),
                     **_flat_calls([(nm, {k: v.numpy() for k, v in
                                          _named_arrays(f, a, kw).items()},
                                     {k: v.numpy() for k, v in o.items()})
                                    for nm, f, a, kw, o in pcalls]))
        print(f"{cell} frame {frame}: the specular chain, chord_tpu against "
              "the port", flush=True)
        _specular_report(jcalls, pcalls, texel, chain)


def _flat_calls(calls) -> dict:
    return {f"{i:02d}|{nm}|{kind}|{k}": v
            for i, (nm, a, o) in enumerate(calls)
            for kind, d in (("in", a), ("out", o)) for k, v in d.items()}


def _unflat_calls(z) -> list:
    calls = {}
    for key in z.files:
        i, nm, kind, k = key.split("|")
        entry = calls.setdefault(int(i), (nm, {}, {}))
        entry[1 if kind == "in" else 2][k] = z[key]
    return [calls[i] for i in sorted(calls)]


def split(cell: str, frame: int) -> None:
    """The split's shadow service, pass by pass, on chord_tpu's own inputs:
    chord_tpu renders frames 0..FRAME of the cell (each frame, then its
    service) and keeps the last frame's split dict, history and service
    outputs; the port's PCSS evaluate, phase expand and temporal blend
    then run on those inputs (chord_tpu's refreshed maps and matrices), and
    each output is compared with chord_tpu's."""
    import jax
    import torch

    import bench_goldens as bg
    import chip_smoke as cs
    import chord_tpu.renderer.meshlet_frame as jmf
    from chord_tpu_torch import interop
    from chord_tpu_torch.ops.bluenoise import interleaved_gradient_noise
    from chord_tpu_torch.ops.shadow import ShadowConfig, evaluate_shadow_auto
    from chord_tpu_torch.renderer import meshlet_frame as mf

    c = bg.setup_cell(cell)
    frame_fn, svc_fn = jmf._split_sequence_fns(c["config"], c["mcfg"])
    h = c["hist"]
    for i in range(frame):
        h = c["step"](i, h)[1]
    view = c["views"][frame]
    _, h, stats = frame_fn(c["pools"], c["inst"], view, h, c["bvh"])
    jsp = stats["shadow_split"]
    jmaps, jmats, jq, jmask = svc_fn(c["pools"], c["inst"], view, h, jsp)
    scfg = c["mcfg"].shadow_cfg
    fc = int(jsp["fc"])
    ph = scfg.temporal_phase if scfg.temporal else 1
    hq, wq = jsp["pos_q"].shape[:2]
    jexp, jphase = jax.jit(jmf._phase_expand, static_argnums=(2, 3, 4))(
        jq, jsp["fc"], ph, hq, wq)

    def t(x):
        return torch.from_numpy(np.array(x))

    sp = {k: t(v) for k, v in jsp.items() if k != "fc"}
    hist = interop.history_from_numpy(
        {k: v if k == "ddgi" else np.asarray(v) for k, v in vars(h).items()},
        device="cpu")
    tview = interop.view_from_numpy(
        {k: np.asarray(v) for k, v in vars(view).items() if v is not None},
        device="cpu")
    tcfg = ShadowConfig(**scfg._asdict())
    noise = (interleaved_gradient_noise(sp["pos_e"].shape[0],
                                        sp["pos_e"].shape[1], fc,
                                        device="cpu")
             if tcfg.jitter else None)
    q = evaluate_shadow_auto(sp["pos_e"], sp["nrm_e"], tview.sun_direction,
                             t(jmaps), t(jmats), tcfg, noise=noise)
    exp, phase = mf._phase_expand(t(jq), fc, ph, hq, wq)

    def blend(m, pm):
        if not tcfg.temporal:
            return m
        return mf._blend_shadow_mask(
            m, pm, sp["pos_q"], hist.shadow_mask, hist.valid, sp["valid_q"],
            sp["disocc_q"], tview.prev_tw_to_clip_nj, tcfg.temporal_alpha)

    mask, mask_j = blend(exp, phase), blend(t(jexp), t(jphase))
    # the port's own frame FRAME (after its frames 0..FRAME-1): its
    # exported split dict and its whole service against chord_tpu's
    scene, pconfig, pmcfg, phist = _port_cell(cell)
    if frame:
        phist = cs.run_path(cell, scene, pconfig, pmcfg, phist, 0, frame)[1]
    pview = scene[2].frame(frame)
    _, phist, pstats = mf.render_frame_meshlet(
        scene[0], scene[1], pview, phist, pconfig, pmcfg, frame_index=frame,
        bvh=scene[4])
    psp = pstats["shadow_split"]
    print(f"{cell} frame {frame}: the port's split dict against chord_tpu's "
          f"(fc {psp['fc']} / {fc}):")
    for k in ("pos_e", "nrm_e", "pos_q", "valid_q", "disocc_q"):
        print(f"  {k} {tuple(psp[k].shape)} "
              f"{_diff(psp[k].numpy(), np.asarray(jsp[k]))}")
    out = mf.shadow_service_step(scene[0], scene[1], pview, phist, psp,
                                 config=pconfig, mcfg=pmcfg)
    for name, a, b in zip(("maps", "mats", "q", "mask"), out,
                          (jmaps, jmats, jq, jmask)):
        print(f"  the port's service: {name} "
              f"{_diff(a.numpy(), np.asarray(b))}")
    print(f"{cell} frame {frame} (fc {fc}), the service on chord_tpu's "
          "inputs:")
    print(f"  PCSS q {tuple(q.shape)} {_diff(q.numpy(), np.asarray(jq))}")
    print(f"  phase expand {_diff(exp.numpy(), np.asarray(jexp))}; phase "
          f"mask {_diff(phase.numpy(), np.asarray(jphase))}")
    print(f"  blended mask {_diff(mask.numpy(), np.asarray(jmask))} (on "
          f"chord_tpu's expand: {_diff(mask_j.numpy(), np.asarray(jmask))})")


def k2(cell: str, frame: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    import bench_goldens as bg
    import chip_smoke as cs
    import chord_tpu.renderer.meshlet_frame as jmf
    from chord_tpu.ops.mesh_shader import META_ROWS, _mesh_shader_kernel
    from chord_tpu.ops.raster import COEF_LANES, WINDOW
    from chord_tpu_torch.ops import kernels
    from chord_tpu_torch.ops import mesh_shader as tms

    c = bg.setup_cell(cell, fma=bg.NO_FMA not in os.environ.get(
        "XLA_FLAGS", ""))
    if c["lvl"]["shadows"]:
        raise SystemExit("k2 records no shadow cascade (chord_tpu renders "
                         "them inside lax.switch); see `history`")
    pools, inst, views, hist = c["pools"], c["inst"], c["views"], c["hist"]
    config, mcfg, bvh = c["config"], c["mcfg"], c["bvh"]
    calls = []
    setup = jmf.mesh_shader_setup

    def recorded(draws, pools_, instances, tw_to_clip, capacity, w, h,
                 **kw):
        out = setup(draws, pools_, instances, tw_to_clip, capacity, w, h,
                    **kw)
        obj = jnp.where(jnp.arange(capacity) < draws.count,
                        draws.object_id, 0)
        l2c = jnp.einsum("dij,jk->dik", instances.object_to_tw[obj],
                         tw_to_clip, precision=jax.lax.Precision.HIGHEST)
        calls.append(dict(mid=draws.meshlet_id, count=draws.count,
                          valid=out.valid, l2c=l2c.reshape(capacity, 16)))
        return out

    def frame_fn(pools, inst, view, hist):
        calls.clear()
        img, hist, stats = jmf.render_frame_meshlet(pools, inst, view, hist,
                                                    config=config, mcfg=mcfg,
                                                    bvh=bvh)
        return hist, stats, list(calls)

    jmf.mesh_shader_setup = recorded
    try:
        fn = jax.jit(frame_fn)
        for i in range(frame + 1):
            hist, jstats, jcalls = fn(pools, inst, views[i], hist)
    finally:
        jmf.mesh_shader_setup = setup
    jcalls = jax.tree.map(np.asarray, jcalls)
    scene, pconfig, pmcfg, phist = _port_cell(cell)
    if frame:
        phist = cs.run_path(cell, scene, pconfig, pmcfg, phist, 0, frame)[1]
    with kernels.capture_inputs() as captured:
        _, _, pstats = cs.run_path(cell, scene, pconfig, pmcfg, phist, frame,
                                   frame + 1)
    print(f"{cell} frame {frame}: chord_tpu stats "
          f"{ {k: int(v) for k, v in jstats.items() if np.ndim(v) == 0} }")
    print(f"{cell} frame {frame}: port stats "
          f"{ {k: int(v[0]) for k, v in pstats.items()} }")
    for c, ((args, kw), j) in enumerate(zip(captured["mesh_shader"],
                                            jcalls)):
        dm, tcnt, count, mats, posT, attrT = (a.numpy() for a in args[:6])
        width, height, base, cull = args[6:10]
        n, cap = int(count[0]), dm.shape[0]
        same = n == int(j["count"]) and np.array_equal(dm[:n], j["mid"][:n])
        mats_same = np.array_equal(mats[:n, :16], j["l2c"][:n])
        print(f"call {c}: {n} draws, equal {same}; per-draw matrices equal "
              f"{mats_same}; valid triangles in the frames: chord_tpu "
              f"{int(j['valid'].sum())}")
        if n == 0:
            continue
        gs = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3, grid=(cap,),
            in_specs=[pl.BlockSpec((8, 128), lambda i, *_: (i // 8, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((12, WINDOW), lambda i, d, *_: (0, d[i]),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((16, WINDOW), lambda i, d, *_: (0, d[i]),
                                   memory_space=pltpu.VMEM)],
            out_specs=[pl.BlockSpec((WINDOW, COEF_LANES),
                                    lambda i, *_: (i, 0),
                                    memory_space=pltpu.VMEM),
                       pl.BlockSpec((META_ROWS, WINDOW),
                                    lambda i, *_: (0, i),
                                    memory_space=pltpu.VMEM)])
        kern = jax.jit(pl.pallas_call(
            functools.partial(_mesh_shader_kernel, width=width,
                              height=height, payload_base=base,
                              backface_cull=cull, sort_tris=False),
            grid_spec=gs, interpret=True,
            out_shape=[jax.ShapeDtypeStruct((cap * WINDOW, COEF_LANES),
                                            jnp.uint32),
                       jax.ShapeDtypeStruct((META_ROWS, cap * WINDOW),
                                            jnp.uint32)]))
        jcoef, jmeta = (np.asarray(x) for x in kern(
            dm, tcnt, count, np.concatenate(
                [mats, np.zeros((cap, 102), np.float32)], 1), posT, attrT))
        jmeta = jmeta.view(np.float32)
        pcoef, pmeta = (x.numpy() for x in tms.mesh_shader_plain(
            *args[:6], width, height, base, cull, False))
        jv, pv = jmeta[0] > 0.5, pmeta[0] > 0.5
        both = jv & pv
        jp = jcoef[:cap * WINDOW, :15].view(np.float32)[both]
        pp = pcoef[:cap * WINDOW, :15].view(np.float32)[both]
        print(f"call {c}, the port's inputs: valid chord_tpu {int(jv.sum())}"
              f", port {int(pv.sum())}, flipped {int((jv != pv).sum())}; "
              f"plane values that differ {int((jp != pp).sum())} of "
              f"{jp.size}")
        for idx in np.nonzero(jv != pv)[0]:
            s, lane = divmod(int(idx), WINDOW)
            m = mats[s, :16].astype(np.float64).reshape(4, 4)
            col = int(dm[s]) * WINDOW + lane
            rows = []
            for k in range(3):
                c_ = np.array([posT[4 * k, col], posT[4 * k + 1, col],
                               posT[4 * k + 2, col], 1.0]) @ m
                rows.append(((c_[0] * 0.5 + c_[3] * 0.5) * width,
                             (c_[3] * 0.5 - c_[1] * 0.5) * height, c_[3]))
            r = np.array(rows)
            sx, sy = r[:, 0] / r[:, 2], r[:, 1] / r[:, 2]
            det = np.linalg.det(r)
            scale = np.prod(np.abs(r).max(1))
            print(f"  slot {s} lane {lane} (meshlet {int(dm[s])}): "
                  f"chord_tpu {bool(jv[idx])}, port {bool(pv[idx])}; x "
                  f"[{sx.min():.6f}, {sx.max():.6f}] y [{sy.min():.6f}, "
                  f"{sy.max():.6f}], centres x "
                  f"{np.ceil(sx.min() - 0.5):.0f}..{np.floor(sx.max() - 0.5):.0f}"
                  f" y {np.ceil(sy.min() - 0.5):.0f}..{np.floor(sy.max() - 0.5):.0f}"
                  f"; det {det:.4e} ({abs(det) / scale:.2e} of the corner "
                  "product)")


def ign() -> None:
    import jax

    from chord_tpu.ops import bluenoise as jbn
    from chord_tpu_torch.ops.bluenoise import interleaved_gradient_noise

    for h, w in ((720, 1280), (180, 320)):
        for f in (0, 7, 31):
            j = np.asarray(jax.jit(lambda f: jbn.interleaved_gradient_noise(
                h, w, f))(np.int32(f)))
            p = interleaved_gradient_noise(h, w, f, device="cpu").numpy()
            print(f"IGN {h}x{w} frame {f}: values that differ "
                  f"{float((j != p).mean()):.4f}")


# `rays`: the rays kept of each rt.trace call of the frame, chosen with a
# seed (call k draws with RAY_SEED + k)
RAY_SEED = 21
RAYS_PER_CALL = 4096


def rays(path: str, check: bool, goldens: str) -> None:
    """The inputs of each rt.trace call of the port's CPU frame 0 of
    `path` (chip_smoke's scene, configs and fresh history), RAYS_PER_CALL
    rays a call chosen with a seed, written to GOLDENS/<path>_rays.npz
    (origins, dirs, t_max, call names; for RTAO's and the specular GI's
    calls the kept rays' pixels, the plane size, pos, normal and rough at
    those pixels and the frame count) for bench_goldens.py's `<path>_rays`
    cell. A scan ray's result depends only on the ray and the step budget,
    so each kept ray's result in a call of the kept rays alone is its
    result in the frame's call; and a pixel's direction depends only on
    its G-buffer values, coordinates and the frame, so the directions made
    from the recorded inputs alone (chip_smoke.ray_directions) are the
    frame's: both checked here on the port. `check`: the port's BVH of the
    path, built on the CPU as chip_smoke builds it, and its directions and
    traces of the recorded rays held to the golden (chip_smoke.hold_rays).
    """
    import torch

    import chip_smoke as cs
    from chord_tpu_torch.ops import gi as gi_ops
    from chord_tpu_torch.ops import rt
    from chord_tpu_torch.ops.gi import GIConfig
    from chord_tpu_torch.renderer import meshlet_frame

    cell = f"{path}_rays"
    if cs.GOLDEN_RAYS.get(cell) != path:
        raise SystemExit(f"no ray cell for {path}: {sorted(cs.GOLDEN_RAYS)}")
    if check:
        t0 = time.time()
        scene = cs.bench_scenes(torch.device("cpu"),
                                cs.scene_paths([path]))[path]
        print(f"{path}: scene and BVH on the CPU in {time.time() - t0:.1f} s",
              flush=True)
        print(json.dumps(cs.hold_rays(cell, scene[4], "cpu")), flush=True)
        return
    t0 = time.time()
    scene, config, mcfg, hist = _port_cell(path)
    print(f"{path}: scene and BVH on the CPU in {time.time() - t0:.1f} s",
          flush=True)
    calls, orig = [], rt.trace

    @functools.wraps(orig)      # rt.trace counts on the module's function
    def recorded(o, d, bvh, t_max=1e9, max_steps=None):
        t, leaf = orig(o, d, bvh, t_max, max_steps)
        calls.append((o.reshape(-1, 3).clone(), d.reshape(-1, 3).clone(),
                      t_max, max_steps, t.reshape(-1).clone(),
                      leaf.reshape(-1).clone()))
        return t, leaf

    # what RTAO's and the specular GI's directions are made of
    made = {"rtao": [], "specular": []}
    rtao, spec_dirs = gi_ops.rtao, meshlet_frame.specular_directions

    def rtao_recorded(pos, normal, bvh, cfg, frame_index=None):
        made["rtao"].append(dict(pos=pos.clone(), normal=normal.clone(),
                                 frame_count=int(frame_index)))
        return rtao(pos, normal, bvh, cfg, frame_index=frame_index)

    def spec_recorded(pos_q, nrm_q, rough_q, frame_count):
        made["specular"].append(dict(pos=pos_q.clone(), normal=nrm_q.clone(),
                                     rough=rough_q.clone(),
                                     frame_count=int(frame_count)))
        return spec_dirs(pos_q, nrm_q, rough_q, frame_count)

    t0 = time.time()
    rt.trace, gi_ops.rtao = recorded, rtao_recorded
    meshlet_frame.specular_directions = spec_recorded
    try:
        cs.run_path(path, scene, config, mcfg, hist, 0, 1)
    finally:
        rt.trace, gi_ops.rtao = orig, rtao
        meshlet_frame.specular_directions = spec_dirs
    print(f"{path} frame 0: {len(calls)} rt.trace calls in "
          f"{time.time() - t0:.1f} s", flush=True)
    ao_radius = (mcfg.gi_cfg or GIConfig()).ao_radius
    names, rtao, other = [], 0, iter(("probe", "specular"))
    for o, d, t_max, max_steps, _, _ in calls:
        if max_steps is not None:
            raise RuntimeError(f"{path}: a call with a step budget")
        if t_max == ao_radius:
            names.append(f"rtao{rtao}")
            rtao += 1
        else:
            names.append(next(other))
    if len(made["rtao"]) != 1 or len(made["specular"]) != 1:
        raise RuntimeError(f"{path} frame 0: {len(made['rtao'])} RTAO and "
                           f"{len(made['specular'])} specular direction "
                           "calls, not one of each")
    n = len(calls)
    keep = {k: [] for k in ("origins", "dirs", "t_max")}
    inputs = dict(pixel=np.full((n, RAYS_PER_CALL), -1, np.int32),
                  plane=np.zeros((n, 2), np.int32),
                  pos=np.zeros((n, RAYS_PER_CALL, 3), np.float32),
                  normal=np.zeros((n, RAYS_PER_CALL, 3), np.float32),
                  rough=np.zeros((n, RAYS_PER_CALL), np.float32))
    frame_count = {m[0]["frame_count"] for m in made.values()}
    if len(frame_count) != 1:
        raise RuntimeError(f"{path}: the direction calls' frame counts "
                           f"{frame_count} differ")
    inputs["frame_count"] = np.array(frame_count.pop(), np.int32)
    for k, (o, d, t_max, _, t, leaf) in enumerate(calls):
        rng = np.random.default_rng(RAY_SEED + k)
        idx = torch.from_numpy(np.sort(rng.choice(o.shape[0], RAYS_PER_CALL,
                                                  replace=False)))
        ts, ls = orig(o[idx], d[idx], scene[4], t_max)
        same = bool(torch.equal(ls, leaf[idx]) and torch.equal(
            ts.view(torch.int32), t[idx].view(torch.int32)))
        print(f"{path} call {names[k]}: {o.shape[0]} rays, t_max {t_max:g}, "
              f"hit share {float((leaf >= 0).float().mean()):.5f}; "
              f"{RAYS_PER_CALL} kept (seed {RAY_SEED + k}), traced alone "
              f"equal to the frame's call: {same}", flush=True)
        if not same:
            raise AssertionError(f"{path} call {names[k]}: the kept rays "
                                 "trace otherwise alone")
        keep["origins"].append(o[idx].numpy())
        keep["dirs"].append(d[idx].numpy())
        keep["t_max"].append(t_max)
        src = made["specular" if names[k] == "specular" else "rtao"][0] \
            if names[k] != "probe" else None
        if src is None:
            continue
        h, w = src["pos"].shape[:2]
        if h * w != o.shape[0]:
            raise RuntimeError(f"{path} call {names[k]}: {o.shape[0]} rays "
                               f"from a {h}x{w} plane")
        inputs["pixel"][k] = idx.numpy()
        inputs["plane"][k] = (h, w)
        for key in ("pos", "normal", "rough"):
            if key in src:
                x = src[key].reshape(h * w, -1)[idx].numpy()
                inputs[key][k] = x.reshape(inputs[key][k].shape)
        mine = cs.ray_directions(names[k], inputs, k, mcfg.gi_cfg,
                                 torch.device("cpu"))
        same = bool(torch.equal(mine.view(torch.int32),
                                d[idx].view(torch.int32)))
        print(f"{path} call {names[k]}: the kept rays' directions made "
              f"from the recorded inputs alone ({h}x{w} plane, frame count "
              f"{int(inputs['frame_count'])}) equal to the frame's: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{path} call {names[k]}: the directions "
                                 "made from the recorded inputs differ")
    out = os.path.join(goldens, f"{cell}.npz")
    np.savez_compressed(out, calls=np.array(names),
                        origins=np.stack(keep["origins"]),
                        dirs=np.stack(keep["dirs"]),
                        t_max=np.array(keep["t_max"], np.float64),
                        seed=np.array(RAY_SEED),
                        call_rays=np.array([c[0].shape[0] for c in calls]),
                        **inputs)
    print(f"wrote {out} ({os.path.getsize(out)} B): {len(calls)} calls of "
          f"{RAYS_PER_CALL} rays; now `JAX_PLATFORMS=cpu python "
          f"tests/bench_goldens.py {cell}`", flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("frames", "history", "split", "dump",
                                     "devdiff", "k2", "ign", "images",
                                     "rays", "specular"))
    ap.add_argument("cell", nargs="?", default="nanite",
                    help="a cell; for images the first PNG")
    ap.add_argument("frame", nargs="?", default="0",
                    help="k2's frame; for images the second PNG")
    ap.add_argument("--goldens", default=os.path.join(HERE, "goldens",
                                                      "bench"))
    ap.add_argument("--frames", type=int)
    ap.add_argument("--save", help="frames: write the port's kept frames "
                    "to this directory")
    ap.add_argument("--timeout", type=float, default=14400.0,
                    help="frames of a strip cell: the ranks' deadline in "
                    "seconds (spawn_strips' default of 600 is too short "
                    "for bench-size frames on the CPU)")
    ap.add_argument("--no-fma", action="store_true")
    ap.add_argument("--check", action="store_true", help="rays: hold the "
                    "port's traces of the recorded rays to the golden "
                    "instead of recording")
    ap.add_argument("--port-dump", help="history: the port's side from a "
                    "`dump` directory (rendered on the card) instead of "
                    "the CPU")
    ap.add_argument("--window", help="history: ROW,COLUMN of a 16x16 "
                    "output window: after each frame, its pixels' levels, "
                    "each image-like leaf's difference over it and the "
                    "port's G-buffer there")
    ap.add_argument("--device", default="cpu", help="dump, devdiff: the "
                    "device")
    ap.add_argument("--funcs", help="devdiff: module alias.function, "
                    "comma-separated (default the specular chain)")
    ap.add_argument("--out", help="dump: the directory written; devdiff "
                    "of a strip cell: where each rank's recorded outputs "
                    "go")
    ap.add_argument("--keep", help="dump: the frames written, e.g. 0,1,7 "
                    "(default every frame)")
    ap.add_argument("--texel", default="75,56", help="specular: ROW,COLUMN "
                    "of the specular plane whose decisions are reported")
    ap.add_argument("--reference", help="specular: chord_tpu's side from "
                    "an earlier run's --out directory")
    ap.add_argument("--extra", help="specular: more ops functions to "
                    "record, comma-separated module.function")
    args = ap.parse_args(argv[1:])
    if args.mode not in ("dump", "devdiff"):
        os.environ["JAX_PLATFORMS"] = "cpu"
    if args.no_fma:
        os.environ["XLA_FLAGS"] = " ".join(
            [os.environ.get("XLA_FLAGS", ""),
             "--xla_cpu_max_isa=SSE4_2"]).strip()
    sys.path[:0] = [HERE, REPO]
    if args.mode == "frames":
        frames(args.cell, args.goldens, args.frames, args.save,
               args.timeout)
    elif args.mode == "history":
        history(args.cell, args.frames, args.port_dump,
                None if args.window is None else
                tuple(int(v) for v in args.window.split(",")))
    elif args.mode == "devdiff":
        devdiff(args.cell, int(args.frame), args.device,
                args.funcs.split(",") if args.funcs else DEVDIFF_FUNCS,
                args.out)
    elif args.mode == "dump":
        dump(args.cell, args.frames, args.device, args.out,
             None if args.keep is None else
             {int(f) for f in args.keep.split(",")})
    elif args.mode == "k2":
        k2(args.cell, int(args.frame))
    elif args.mode == "split":
        split(args.cell, int(args.frame))
    elif args.mode == "rays":
        rays(args.cell, args.check, args.goldens)
    elif args.mode == "specular":
        specular(args.cell, int(args.frame), args.frames,
                 tuple(int(v) for v in args.texel.split(",")), args.out,
                 args.reference,
                 args.extra.split(",") if args.extra else ())
    elif args.mode == "images":
        import chip_smoke as cs
        print(json.dumps(cs.image_gates(cs.read_png(args.cell),
                                        cs.read_png(args.frame))))
    else:
        ign()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
