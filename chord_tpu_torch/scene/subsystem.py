"""SceneSubsystem: mesh/material library + active scene -> device state
(port of chord_tpu/scene/subsystem.py).

The port of the reference SceneSubsystem + GPUScene pair
(reference: scene/scene_subsystem.h:10 — active-scene holder, camera
registry with per-camera PerframeCollected; renderer/gpu_scene.h — the
persistent pools the collections are uploaded into).

The library registers meshes/materials by string key; the first render
builds the meshlet device pools on the subsystem's `device` (None = the
card; with the C++ Nanite builder when available) and the subsystem maps
each frame's collected instances onto
pool slots — the scatter-upload analog (GPUScene::update) where the
"upload" is just building the small per-frame FrameInstances arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..rhi.scene_arrays import (FrameInstances, MaterialData, MeshData,
                                SceneBuilder)
from ..utils.log import get_logger
from .components import PerframeCollected
from .scene import Scene

log = get_logger("scene.subsystem")


class SceneSubsystem:
    """Owns the active scene, the asset library, and the device pools."""

    def __init__(self, nanite: bool = True, device=None):
        self.scene: Optional[Scene] = None
        self.meshes: Dict[str, MeshData] = {}
        self.materials: Dict[str, MaterialData] = {"default": MaterialData()}
        self.nanite = nanite
        self.device = device
        self._pools = None
        self._mesh_slot: Dict[str, int] = {}
        self._mat_slot: Dict[str, int] = {}
        self._builder: Optional[SceneBuilder] = None
        self._max_instances = 0

    # --- library ----------------------------------------------------------
    def register_builtin_meshes(self) -> None:
        """Register the builtin primitive library (the reference ships
        builtin meshes for gizmos/debug, graphics.cpp builtin meshes):
        box, sphere, plane, cylinder under stable keys."""
        from ..asset.procedural import (make_box, make_cylinder, make_plane,
                                        make_uv_sphere)

        for key, mesh in (("builtin.box", make_box()),
                          ("builtin.sphere", make_uv_sphere(1.0)),
                          ("builtin.plane", make_plane(1.0)),
                          ("builtin.cylinder", make_cylinder())):
            if key not in self.meshes:
                self.register_mesh(key, mesh)

    def register_mesh(self, key: str, mesh: MeshData) -> None:
        if key in self.meshes:
            raise KeyError(f"mesh '{key}' already registered")
        self.meshes[key] = mesh
        self._pools = None        # pools rebuild on next frame

    def register_material(self, key: str, mat: MaterialData) -> None:
        self.materials[key] = mat
        self._pools = None

    def set_scene(self, scene: Scene) -> None:
        self.scene = scene

    def frame_state(self, collected: PerframeCollected, camera):
        """Collected instances -> (pools, FrameInstances) for the renderer.

        Rebuilds the static pair table when the INSTANCE SET changes (the
        mesh keys in order); per-frame motion only refreshes the small
        FrameInstances arrays (the reference's per-frame upload path).
        Both land on the subsystem's device.
        """
        from ..native import available
        from ..rhi.meshlet_scene import build_meshlet_pools

        keys = tuple(mk for mk, _, _ in collected.instances)
        if self._pools is None or keys != getattr(self, "_last_keys", None):
            b = SceneBuilder()
            self._mat_slot = {k: b.add_material(m)
                              for k, m in self.materials.items()}
            self._mesh_slot = {k: b.add_mesh(m)
                               for k, m in self.meshes.items()}
            for mesh_key, mat_key, l2w in collected.instances:
                b.add_instance(self._mesh_slot[mesh_key],
                               self._mat_slot.get(mat_key,
                                                  self._mat_slot["default"]),
                               l2w)
            self._builder = b
            self._pools = build_meshlet_pools(
                b, nanite=self.nanite and available(), device=self.device)
            self._last_keys = keys
            self._prev_l2w = None     # instance set changed: no history
        else:
            # refresh transforms only
            for i, (mesh_key, mat_key, l2w) in enumerate(collected.instances):
                mesh_id, mat_id, _ = self._builder.instances[i]
                self._builder.instances[i] = (mesh_id, mat_id, l2w)
        # per-object motion: last frame's WORLD transforms rebased to the
        # CURRENT camera origin (translated world) — feeds the rigid-delta
        # motion vectors in the gbuffer resolve (ops/shading.py)
        prev = None
        if getattr(self, "_prev_l2w", None) is not None:
            prev = {i: camera.rebase_matrix(m)
                    for i, m in enumerate(self._prev_l2w)}
        inst = self._builder.frame_instances(camera, prev_matrices=prev,
                                             device=self.device)
        self._prev_l2w = [np.array(l2w)
                          for _, _, l2w in collected.instances]
        return self._pools, inst
