"""The hand-written CUDA kernels of the port, with their plain versions.

One entry per kernel: the module, the wrapper that launches the CUDA
kernel (and counts its launches in `wrapper.launches`), the plain PyTorch
version with the same signature, the CUDA source, the chord_tpu Pallas
kernel it replaces and the paths (`paths`) that launch it: a frame path
of PATHS or a tool path of TOOL_PATHS.
`capture_inputs` records the arguments each wrapper receives while a frame
runs, so a check can hold kernel and plain version against each other on
a path's own inputs and shapes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from . import (fusion_barrier, mesh_shader, paged_texture, proto_paged_tex,
               raster, row_gather, shadow, shadow_kernel, tile_reproject)

# the paths the port renders: the bench rungs (bench.py FEATURE_LEVELS;
# `all_no_rt` is the `all` rung with gi_rt=False), `geo_tex` with the
# r.raster.bricks cvar set, and the flat DeferredRenderer frame with
# RendererConfig(subtiles=True)
PATHS = ("off", "geo_tex", "geo_shadow_atmo", "geo_tex_bricks", "flat",
         "all_no_rt")
MESHLET = ("off", "geo_tex", "geo_shadow_atmo", "geo_tex_bricks",
           "all_no_rt")
# launches of a kernel on a path's 16-frame run that the path fixes (K4:
# TSR's history and, on `all_no_rt`, the GI diffuse history every frame)
EXPECTED_LAUNCHES = {
    "off": {"tile_reproject": 16},
    "geo_tex": {"tile_reproject": 16, "paged_texture": 32},
    "geo_shadow_atmo": {"tile_reproject": 16, "paged_texture": 40,
                        "pcss": 16},
    "geo_tex_bricks": {"tile_reproject": 16, "paged_texture": 32,
                       "raster_bricks": 64},
    "flat": {"raster_subtile": 16},
    "all_no_rt": {"tile_reproject": 32, "paged_texture": 40, "pcss": 16},
}
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
    paths: Tuple[str, ...] = MESHLET

    def fn(self) -> Callable:
        return getattr(self.module, self.wrapper)


KERNELS: List[Kernel] = [
    Kernel("raster", raster, "raster_tiles", raster.raster_tiles_plain,
           "chord_tpu_torch/csrc/raster.cu", "chord_tpu/ops/raster.py:488",
           paths=("off", "geo_tex", "geo_shadow_atmo", "all_no_rt")),
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
           "chord_tpu/ops/tile_reproject.py:55"),
    Kernel("paged_texture", paged_texture, "paged_sample",
           paged_texture.paged_sample_plain,
           "chord_tpu_torch/csrc/paged_texture.cu",
           "chord_tpu/ops/paged_texture.py:251",
           paths=("geo_tex", "geo_shadow_atmo", "geo_tex_bricks",
                  "all_no_rt")),
    Kernel("pcss", shadow_kernel, "pcss", shadow.pcss_plain,
           "chord_tpu_torch/csrc/pcss.cu",
           "chord_tpu/ops/shadow_kernel.py:145",
           paths=("geo_shadow_atmo", "all_no_rt")),
    Kernel("raster_bricks", raster, "raster_bricks",
           raster.raster_bricks_plain,
           "chord_tpu_torch/csrc/raster_bricks.cu",
           "chord_tpu/ops/raster.py:740", paths=("geo_tex_bricks",)),
    Kernel("raster_subtile", raster, "raster_subtile",
           raster.raster_subtile_plain,
           "chord_tpu_torch/csrc/raster_subtile.cu",
           "chord_tpu/ops/raster.py:1233", paths=("flat",)),
    Kernel("fusion_barrier", fusion_barrier, "fusion_barrier",
           fusion_barrier.fusion_barrier_plain,
           "chord_tpu_torch/csrc/fusion_barrier.cu",
           "chord_tpu/ops/fusion_barrier.py:29", paths=("repro_eval",)),
    Kernel("proto_paged_sample", proto_paged_tex, "paged_sample",
           proto_paged_tex.paged_sample_plain,
           "chord_tpu_torch/csrc/proto_paged_tex.cu",
           "tools/proto_paged_tex.py:70", paths=("proto_paged_tex",)),
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
