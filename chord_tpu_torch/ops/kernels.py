"""The hand-written CUDA kernels of the port, with their plain versions.

One entry per kernel: the module, the wrapper that launches the CUDA
kernel (and counts its launches in `wrapper.launches`), the plain PyTorch
version with the same signature, the CUDA source and the chord_tpu Pallas
kernel it replaces. `capture_inputs` records the arguments each wrapper
receives while the frame runs, so a check can hold kernel and plain
version against each other on the main path's own inputs and shapes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

from . import mesh_shader, raster, row_gather, tile_reproject


@dataclass(frozen=True)
class Kernel:
    name: str
    module: object          # module whose global the frame calls
    wrapper: str            # name of the wrapper in `module`
    plain: Callable
    source: str
    replaces: str

    def fn(self) -> Callable:
        return getattr(self.module, self.wrapper)


KERNELS: List[Kernel] = [
    Kernel("raster", raster, "raster_tiles", raster.raster_tiles_plain,
           "chord_tpu_torch/csrc/raster.cu", "chord_tpu/ops/raster.py:488"),
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
