"""Carry state from chord_tpu into this package.

chord_tpu's objects go in as mappings of numpy arrays, e.g.
`{k: np.asarray(v) for k, v in vars(pools).items() if v is not None}` for
its MeshletScenePools / FrameInstances / DeviceView / FrameHistory; each
function keeps the fields the port's counterpart has and moves them to
`device` (None = the card, as everywhere in the port). Nothing here
imports chord_tpu or jax: the tests use it to feed both packages identical
state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .renderer.deferred import DeviceView
from .rhi.framebuffer import FrameHistory
from .rhi.meshlet_scene import MeshletScenePools
from .rhi.scene_arrays import FrameInstances
from .utils.device import resolve


def _build(cls, arrays: Mapping[str, np.ndarray], device):
    device = resolve(device)

    def conv(name):
        a = np.asarray(arrays[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        # np.array copies: contiguous, writable, and 0-d stays 0-d
        return torch.from_numpy(np.array(a)).to(device)
    return cls(**{f.name: conv(f.name) for f in dataclasses.fields(cls)})


def pools_from_numpy(arrays, device=None) -> MeshletScenePools:
    """Also carries the texture pools (tex_pool u8, tex_pages, tex_meta)."""
    return _build(MeshletScenePools, arrays, device)


def instances_from_numpy(arrays, device=None) -> FrameInstances:
    return _build(FrameInstances, arrays, device)


def view_from_numpy(arrays, device=None) -> DeviceView:
    """A single or a stacked (leading (N,) axis) view."""
    return _build(DeviceView, arrays, device)


def history_from_numpy(arrays, device=None) -> FrameHistory:
    return _build(FrameHistory, arrays, device)
