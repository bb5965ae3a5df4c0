"""Carry state from chord_tpu into this package.

chord_tpu's objects go in as mappings of numpy arrays, e.g.
`{k: np.asarray(v) for k, v in vars(pools).items() if v is not None}` for
its ScenePools / MeshletScenePools / FrameInstances / DeviceView /
FrameHistory; each function keeps the fields the port's counterpart has
and moves them to `device` (None = the card, as everywhere in the port).
Nothing here imports chord_tpu or jax: the tests use it to feed both
packages identical state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .renderer.deferred import SHARED_FIELDS, DeviceView
from .rhi.framebuffer import FrameHistory
from .rhi.meshlet_scene import MeshletScenePools
from .rhi.scene_arrays import FrameInstances, ScenePools
from .utils.device import resolve


def _build(cls, arrays: Mapping[str, np.ndarray], device):
    """Fields with a default (the optional ones) may be missing or None."""
    device = resolve(device)

    def conv(f):
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
    """With the shadow fields (mask, cached maps and their matrices) and
    the GI fields (world cache, probe SH and depth, diffuse and specular
    histories). chord_tpu's `ddgi` leaf (a DDGIState pytree) is not
    carried: the port has no DDGI path to read it."""
    return _build(FrameHistory, arrays, device)
