"""The hand-written CUDA kernels of the port, with their plain versions.

One entry per kernel: the module, the wrapper that launches the CUDA
kernel (and counts its launches in `wrapper.launches`), the plain PyTorch
version with the same signature, the CUDA source, the chord_tpu Pallas
kernel it replaces (the sincos and powf kernels replace none: they
compute chord_tpu's XLA f32 sin and cos and its f32 power, glibc's sinf,
cosf and powf, on the card) and
the paths (`paths`) that launch it: a frame path of PATHS, a tool path of
TOOL_PATHS or an app run of APP_PATHS.
`capture_inputs` records the arguments each wrapper receives while a frame
runs, so a check can hold kernel and plain version against each other on
a path's own inputs and shapes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from . import (_util, fusion_barrier, mesh_shader, paged_texture,
               proto_paged_tex, raster, row_gather, shadow, shadow_kernel,
               tile_reproject)

# the paths the port renders: the bench rungs (bench.py FEATURE_LEVELS;
# `all_no_rt` is the `all` rung with gi_rt=False), the `all` rung with
# DDGI over a meshlet BVH (`all_ddgi`) and with the triangle-exact BVH,
# RTAO and the probe march (`all_exact`), `geo_tex` with the
# r.raster.bricks cvar set, the flat DeferredRenderer frame with
# RendererConfig(subtiles=True), `geo_tex` rendered natively at the post
# size with gather TSR and the masked depth peel (`geo_tex_native`),
# `off` without occlusion or pre-cull, with global TSR and the HDR10
# output (`off_no_occlusion`), `geo_shadow_atmo` with the pipelined
# shadow split (`geo_shadow_atmo_split`), and BASELINE configs #4 and #3
# as bench.py's `--scene interior` (the `all` rung) and `--scene nanite`
# (the `off` rung), BASELINE config #5 as the `all` rung at
# --width 3840 --height 2160 (`all_4k`: render 2560x1440, bench.py's 4K
# capacities), and `all` with the world-cache GI (`all_cache`, the
# viewer's --gi --gi-mode cache --gi-rt); then the strip-parallel frames
# (parallel/sharded.py), two ranks on one card, each rendering half of
# the image: the `all` rung's frame at its native 1920x1080 and the flat
# frame (`sharded_all`, `sharded_flat`)
PATHS = ("off", "geo_tex", "geo_shadow_atmo", "geo_tex_bricks", "flat",
         "all_no_rt", "all", "all_ddgi", "all_exact", "geo_tex_native",
         "off_no_occlusion", "geo_shadow_atmo_split", "interior", "nanite",
         "all_4k", "all_cache", "sharded_all", "sharded_flat")
SHARDED = ("sharded_all", "sharded_flat")
# the paths one process renders
FRAME_PATHS = tuple(p for p in PATHS if p not in SHARDED)
FLAT = ("flat", "sharded_flat")
MESHLET = tuple(p for p in PATHS if p not in FLAT)
GI_PATHS = ("all_no_rt", "all", "all_ddgi", "all_exact", "interior",
            "all_4k", "all_cache", "sharded_all")
SHADOW = ("geo_shadow_atmo", "geo_shadow_atmo_split") + GI_PATHS
# the meshlet paths whose TSR runs in tile mode (K4; on `sharded_all` at
# render size)
TILE_TSR = ("off", "geo_tex", "geo_shadow_atmo", "geo_tex_bricks",
            "all_no_rt", "all", "all_ddgi", "all_exact",
            "geo_shadow_atmo_split", "interior", "nanite", "all_4k",
            "all_cache", "sharded_all")
# the apps' runs: the editor's `render` of an imported street at 1920x1080
# (no TSR, no occlusion), and the viewer with --shadows --atmosphere on
# assets/demo_street.glb (textured, masked leaves; gather TSR) and on a
# .chtp scene the editor saved (builtin meshes, untextured)
APP_PATHS = ("editor", "viewer_glb", "viewer_chtp")
# frames in a path's run: 16, but 4 on `all_exact`, whose six traces a
# frame take the lock-step BVH scan (seconds a frame on the card)
RUN_FRAMES = {"all_exact": 4}


def run_frames(path: str) -> int:
    return RUN_FRAMES.get(path, 16)


# the sincos kernel's calls a frame: the PCSS disk rotation on the shadow
# paths, the specular GI's GGX azimuth on the GI paths and RTAO's 4 rays
# on `all_exact`
SINCOS_PER_FRAME = {p: (1 if p in SHADOW else 0) + (1 if p in GI_PATHS
                                                    else 0)
                    for p in PATHS}
SINCOS_PER_FRAME["all_exact"] += 4
# the powf kernel's calls a frame: the specular filters' edge weights on
# the GI paths, one call for the firefly clamp's and one for the spatial
# filter's
POWF_PER_FRAME = {p: 2 if p in GI_PATHS else 0 for p in PATHS}
# launches of a kernel on a path's run that the path fixes, per rank on
# the sharded paths (K4:
# TSR's history and, with screen probes, the GI diffuse history every
# frame (DDGI and the world-cache mode keep no such history); K5 the resolve and each masked
# layer's alpha test, and on the shadow paths the masked casters of the
# frames that refresh cascade 0 or 1; K1 on geo_tex_native the two
# occlusion phases, the
# masked layer, its peel and the blend bucket; the BVH rays, RTAO, DDGI
# and the probe march launch no kernel of their own; the sincos kernel
# SINCOS_PER_FRAME, added below)
EXPECTED_LAUNCHES = {
    "off": {"tile_reproject": 16},
    "geo_tex": {"tile_reproject": 16, "paged_texture": 32},
    "geo_shadow_atmo": {"tile_reproject": 16, "paged_texture": 40,
                        "pcss": 16},
    "geo_tex_bricks": {"tile_reproject": 16, "paged_texture": 32,
                       "raster_bricks": 64},
    "flat": {"raster_subtile": 16},
    "all_no_rt": {"tile_reproject": 32, "paged_texture": 40, "pcss": 16},
    "all": {"tile_reproject": 32, "paged_texture": 40, "pcss": 16},
    "all_ddgi": {"tile_reproject": 16, "paged_texture": 40, "pcss": 16},
    "all_exact": {"tile_reproject": 8, "paged_texture": 10, "pcss": 4},
    "geo_tex_native": {"raster": 80, "paged_texture": 48},
    "off_no_occlusion": {"raster": 16},
    # the split runs the inline path's kernels: the service refreshes one
    # cascade and evaluates PCSS once a frame (interior: no texture pool,
    # but the textured rung's resolve, masked test and masked casters
    # sample the empty one)
    "geo_shadow_atmo_split": {"tile_reproject": 16, "paged_texture": 40,
                              "pcss": 16},
    "interior": {"tile_reproject": 32, "paged_texture": 40, "pcss": 16},
    "nanite": {"tile_reproject": 16},
    "all_4k": {"tile_reproject": 32, "paged_texture": 40, "pcss": 16},
    "all_cache": {"tile_reproject": 16, "paged_texture": 40, "pcss": 16},
    # each rank's strip runs the whole frame: `all`'s kernels, the TSR
    # and GI histories at the strip's size; the flat frame's K8
    "sharded_all": {"tile_reproject": 32, "paged_texture": 40, "pcss": 16},
    "sharded_flat": {"raster_subtile": 16},
    # every kernel call of a run: the editor renders one frame; the viewer
    # 4 frames after 3 cascade warm-up frames (K5: the resolve and the
    # masked test a frame, the masked casters of the 4 frames refreshing
    # cascade 0 or 1)
    "editor": {"raster": 1, "mesh_shader": 1, "row_gather": 2},
    "viewer_glb": {"raster": 32, "mesh_shader": 32, "row_gather": 25,
                   "paged_texture": 18, "pcss": 7},
    "viewer_chtp": {"raster": 21, "mesh_shader": 21, "row_gather": 14,
                    "pcss": 7},
}
for _p, _n in SINCOS_PER_FRAME.items():
    if _n:
        EXPECTED_LAUNCHES[_p]["sincos"] = _n * run_frames(_p)
for _p, _n in POWF_PER_FRAME.items():
    if _n:
        EXPECTED_LAUNCHES[_p]["powf"] = _n * run_frames(_p)
# the viewer's PCSS calls rotate their disks too
for _p in ("viewer_glb", "viewer_chtp"):
    EXPECTED_LAUNCHES[_p]["sincos"] = EXPECTED_LAUNCHES[_p]["pcss"]
# the port's tools: every variant of tools/repro_eval_kernel.py, and
# tools/proto_paged_tex.py's main at its own size
TOOL_PATHS = ("repro_eval", "proto_paged_tex")


@dataclass(frozen=True)
class Kernel:
    name: str
    module: object          # module whose global the frame calls
    wrapper: str            # name of the wrapper in `module`
    plain: Callable
    source: str
    replaces: str
    paths: Tuple[str, ...] = MESHLET + APP_PATHS

    def fn(self) -> Callable:
        return getattr(self.module, self.wrapper)


KERNELS: List[Kernel] = [
    Kernel("raster", raster, "raster_tiles", raster.raster_tiles_plain,
           "chord_tpu_torch/csrc/raster.cu", "chord_tpu/ops/raster.py:488",
           paths=tuple(p for p in MESHLET if p != "geo_tex_bricks") +
           APP_PATHS),
    Kernel("mesh_shader", mesh_shader, "mesh_shader",
           mesh_shader.mesh_shader_plain,
           "chord_tpu_torch/csrc/mesh_shader.cu",
           "chord_tpu/ops/mesh_shader.py:58"),
    Kernel("row_gather", row_gather, "gather_rows",
           row_gather.gather_rows_plain,
           "chord_tpu_torch/csrc/row_gather.cu",
           "chord_tpu/ops/row_gather.py:71"),
    Kernel("tile_reproject", tile_reproject, "reproject_tiles",
           tile_reproject.reproject_tiles_plain,
           "chord_tpu_torch/csrc/tile_reproject.cu",
           "chord_tpu/ops/tile_reproject.py:55", paths=TILE_TSR),
    Kernel("paged_texture", paged_texture, "paged_sample",
           paged_texture.paged_sample_plain,
           "chord_tpu_torch/csrc/paged_texture.cu",
           "chord_tpu/ops/paged_texture.py:251",
           paths=("geo_tex", "geo_tex_bricks", "geo_tex_native",
                  "viewer_glb") + SHADOW),
    Kernel("pcss", shadow_kernel, "pcss", shadow.pcss_plain,
           "chord_tpu_torch/csrc/pcss.cu",
           "chord_tpu/ops/shadow_kernel.py:145",
           paths=SHADOW + ("viewer_glb", "viewer_chtp")),
    Kernel("raster_bricks", raster, "raster_bricks",
           raster.raster_bricks_plain,
           "chord_tpu_torch/csrc/raster_bricks.cu",
           "chord_tpu/ops/raster.py:740", paths=("geo_tex_bricks",)),
    Kernel("raster_subtile", raster, "raster_subtile",
           raster.raster_subtile_plain,
           "chord_tpu_torch/csrc/raster_subtile.cu",
           "chord_tpu/ops/raster.py:1233", paths=FLAT),
    Kernel("fusion_barrier", fusion_barrier, "fusion_barrier",
           fusion_barrier.fusion_barrier_plain,
           "chord_tpu_torch/csrc/fusion_barrier.cu",
           "chord_tpu/ops/fusion_barrier.py:29", paths=("repro_eval",)),
    Kernel("proto_paged_sample", proto_paged_tex, "paged_sample",
           proto_paged_tex.paged_sample_plain,
           "chord_tpu_torch/csrc/proto_paged_tex.cu",
           "tools/proto_paged_tex.py:70", paths=("proto_paged_tex",)),
    Kernel("sincos", _util, "sincosf", _util.sincosf_plain,
           "chord_tpu_torch/csrc/sincos.cu",
           "none: chord_tpu's XLA f32 sin / cos (glibc sinf, cosf) at "
           "chord_tpu/ops/gi.py:365, screen_probe.py:673, shadow.py:274, "
           "shadow_kernel.py:382",
           paths=SHADOW + ("viewer_glb", "viewer_chtp", "repro_eval")),
    Kernel("powf", _util, "powf", _util.powf_plain,
           "chord_tpu_torch/csrc/powf.cu",
           "none: chord_tpu's XLA f32 power (glibc powf) at "
           "chord_tpu/ops/screen_probe.py:631",
           paths=GI_PATHS),
]


def launch_counts() -> Dict[str, int]:
    return {k.name: k.fn().launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.fn().launches = 0


@contextlib.contextmanager
def capture_inputs():
    """Within the block, every call of a kernel wrapper appends its
    (args, kwargs) to captured[name]; the wrappers are restored after."""
    captured: Dict[str, list] = {k.name: [] for k in KERNELS}
    originals = {}
    for k in KERNELS:
        orig = k.fn()
        originals[k.name] = orig

        def rec(*args, _orig=orig, _name=k.name, **kwargs):
            captured[_name].append((args, kwargs))
            return _orig(*args, **kwargs)

        # the wrapper counts through its module global, i.e. on `rec`
        # while patched: carry the count across
        rec.launches = orig.launches
        setattr(k.module, k.wrapper, rec)
    try:
        yield captured
    finally:
        for k in KERNELS:
            originals[k.name].launches = k.fn().launches
            setattr(k.module, k.wrapper, originals[k.name])


def outputs_list(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return list(out)


def max_abs_err(a: List[torch.Tensor], b: List[torch.Tensor]) -> float:
    """Largest |a-b| over all outputs (integer outputs compare exactly and
    count any mismatch as inf; NaN positions must agree)."""
    worst = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        if not x.dtype.is_floating_point:
            if not torch.equal(x, y):
                return float("inf")
            continue
        nan_x, nan_y = torch.isnan(x), torch.isnan(y)
        if not torch.equal(nan_x, nan_y):
            return float("inf")
        d = (x - y).abs()[~nan_x]
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst
