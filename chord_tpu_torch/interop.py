"""Carry state from chord_tpu into this package.

chord_tpu's objects go in as mappings of numpy arrays, e.g.
`{k: np.asarray(v) for k, v in vars(pools).items() if v is not None}` for
its ScenePools / MeshletScenePools / FrameInstances / DeviceView /
FrameHistory (`bvh._asdict()` for its SceneBVH); each function keeps the
fields the port's counterpart has and moves them to `device` (None = the
card, as everywhere in the port).
Nothing here imports chord_tpu or jax: the tests use it to feed both
packages identical state. `to_numpy` goes the other way, from this
package's pools, instances, views or BVH to such a mapping (how a strip
job hands a scene to its ranks, parallel/sharded.py).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .ops.ddgi import DDGIState
from .ops.rt import SceneBVH
from .renderer.deferred import SHARED_FIELDS, DeviceView
from .rhi.framebuffer import FrameHistory
from .rhi.meshlet_scene import MeshletScenePools
from .rhi.scene_arrays import FrameInstances, ScenePools
from .utils.device import resolve


def _build(cls, arrays: Mapping[str, np.ndarray], device, keep=()):
    """Fields with a default (the optional ones) may be missing or None;
    those named in `keep` go in as they are."""
    device = resolve(device)

    def conv(f):
        if f.name in keep:
            return arrays[f.name]
        if arrays.get(f.name) is None and f.default is None:
            return None
        a = np.asarray(arrays[f.name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        # np.array copies: contiguous, writable, and 0-d stays 0-d
        return torch.from_numpy(np.array(a)).to(device)
    return cls(**{f.name: conv(f) for f in dataclasses.fields(cls)})


def pools_from_numpy(arrays, device=None) -> MeshletScenePools:
    """Also carries the texture pools (tex_pool u8, tex_pages, tex_meta)."""
    return _build(MeshletScenePools, arrays, device)


def scene_pools_from_numpy(arrays, device=None) -> ScenePools:
    """chord_tpu's flat ScenePools (SceneBuilder.build_pools)."""
    return _build(ScenePools, arrays, device)


def instances_from_numpy(arrays, device=None) -> FrameInstances:
    return _build(FrameInstances, arrays, device)


def view_from_numpy(arrays, device=None) -> DeviceView:
    """A single or a stacked (leading (N,) axis) view, with the shadow,
    camera, atmosphere-LUT and env-BRDF-LUT fields where present. A LUT
    stacked per frame (chord_tpu stacks every view leaf) is carried once:
    a path shares it."""
    arrays = dict(arrays)
    for name in SHARED_FIELDS:
        if arrays.get(name) is not None and np.ndim(arrays[name]) == 4:
            arrays[name] = np.asarray(arrays[name])[0]
    return _build(DeviceView, arrays, device)


def history_from_numpy(arrays, device=None) -> FrameHistory:
    """With the shadow fields (mask, cached maps and their matrices), the
    GI fields (world cache, probe SH and depth, diffuse and specular
    histories) and chord_tpu's `ddgi` leaf (a DDGIState, or a mapping of
    its fields) through ddgi_from_numpy; without a `ddgi` entry the
    history carries chord_tpu's off-placeholder."""
    hist = _build(FrameHistory, dict(arrays, ddgi=None), device,
                  keep=("ddgi",))
    ddgi = arrays.get("ddgi")
    return dataclasses.replace(hist, ddgi=(
        DDGIState.empty(device=resolve(device)) if ddgi is None
        else ddgi_from_numpy(ddgi, device)))


def ddgi_from_numpy(arrays, device=None) -> DDGIState:
    """chord_tpu's DDGIState (irradiance and distance texels, SH, offsets,
    weights), as a NamedTuple or a mapping of its fields."""
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    device = resolve(device)
    return DDGIState(**{f: torch.from_numpy(np.array(arrays[f])).to(device)
                        for f in DDGIState._fields})


def bvh_from_numpy(arrays, device=None) -> SceneBVH:
    """chord_tpu's SceneBVH (node spheres, skip counts, leaf ids, the leaf
    shading table, the raw leaf spheres; its triangle-exact fields where
    present), so both packages trace the same BVH."""
    device = resolve(device)
    conv = lambda a: (None if a is None else
                      torch.from_numpy(np.array(a)).to(device))
    return SceneBVH(**{f: conv(arrays.get(f)) for f in SceneBVH._fields})


def to_numpy(obj) -> dict:
    """A dataclass of tensors (pools, instances, a view, a history without
    its DDGI state) or a SceneBVH -> {field: numpy array or None}, the
    mapping the *_from_numpy functions take."""
    items = (obj._asdict().items() if hasattr(obj, "_asdict") else
             ((f.name, getattr(obj, f.name))
              for f in dataclasses.fields(obj)))
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in items}
