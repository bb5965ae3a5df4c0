"""Scene graph: node tree + per-frame collection + save/load (port of
chord_tpu/scene/scene.py).

The port of the reference Scene asset (reference:
source/scene/scene.h:16 Scene : IAsset owning a SceneNode tree; tick
clears per-camera collectors, ticks the tree top-down, then every node
collects per registered camera, scene/scene.cpp:107-137). Serialization is
a compressed JSON container (chord uses cereal+LZ4; see
asset/serialize.py for the binary container).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..utils.log import get_logger
from .components import (Component, PerframeCollected, TransformComponent,
                         component_from_dict)

log = get_logger("scene")


class SceneNode:
    """Classic scene-graph node (reference: scene/scene_node.h)."""

    _next_id = 1

    def __init__(self, name: str = "node"):
        self.id = SceneNode._next_id
        SceneNode._next_id += 1
        self.name = name
        self.parent: Optional["SceneNode"] = None
        self.children: List["SceneNode"] = []
        self.components: List[Component] = []
        self.transform = TransformComponent()
        self.transform.node = self
        self.visible = True

    def add_child(self, node: "SceneNode") -> "SceneNode":
        node.parent = self
        self.children.append(node)
        return node

    def add_component(self, comp: Component) -> Component:
        comp.node = self
        self.components.append(comp)
        return comp

    def get_component(self, cls) -> Optional[Component]:
        for c in self.components:
            if isinstance(c, cls):
                return c
        return None

    def world_matrix(self) -> np.ndarray:
        m = self.transform.local_matrix()
        if self.parent is not None:
            return m @ self.parent.world_matrix()
        return m

    def traverse(self) -> Iterator["SceneNode"]:
        yield self
        for c in self.children:
            yield from c.traverse()

    # --- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "visible": self.visible,
            "transform": self.transform.to_dict(),
            "components": [c.to_dict() for c in self.components],
            "children": [c.to_dict() for c in self.children],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SceneNode":
        n = cls(d.get("name", "node"))
        n.visible = d.get("visible", True)
        t = component_from_dict(d["transform"])
        n.transform = t
        t.node = n
        for cd in d.get("components", []):
            n.add_component(component_from_dict(cd))
        for ch in d.get("children", []):
            n.add_child(cls.from_dict(ch))
        return n


class Scene:
    """Scene asset: root node + tick/collect (reference: scene/scene.h:16).

    `tick(dt, cameras)` returns one PerframeCollected per camera — the
    host-side hot loop the reference runs in Scene::tick (the analog of
    perviewPerframeCollect, component_gltf_mesh.cpp:68-117)."""

    def __init__(self, name: str = "scene"):
        self.name = name
        self.root = SceneNode("root")
        self.dirty = False

    def tick(self, dt: float, n_views: int = 1) -> List[PerframeCollected]:
        collectors = [PerframeCollected() for _ in range(n_views)]

        def walk(node: SceneNode) -> None:
            if not node.visible:    # invisible prunes the whole subtree
                return
            for comp in node.components:
                comp.tick(dt)
            world = node.world_matrix()
            for col in collectors:
                for comp in node.components:
                    comp.collect(col, world)
            for child in node.children:
                walk(child)

        walk(self.root)
        return collectors

    def find(self, name: str) -> Optional[SceneNode]:
        for n in self.root.traverse():
            if n.name == name:
                return n
        return None

    # --- persistence -------------------------------------------------------
    def to_dict(self) -> dict:
        return {"name": self.name, "root": self.root.to_dict(),
                "version": 1}

    @classmethod
    def from_dict(cls, d: dict) -> "Scene":
        s = cls(d.get("name", "scene"))
        s.root = SceneNode.from_dict(d["root"])
        return s

    def save(self, path, thumbnail=None) -> None:
        """`thumbnail`: optional (H,W,3) u8 frame stored in the header
        meta (readable via asset.serialize.load_meta without loading the
        scene — the reference's editor snapshot, asset.h)."""
        from ..asset.serialize import encode_thumbnail, save_asset

        meta = {"name": self.name}
        if thumbnail is not None:
            meta["thumbnail"] = encode_thumbnail(thumbnail)
        save_asset(Path(path), "scene", self.to_dict(), meta=meta)
        self.dirty = False
        log.info("scene '%s' saved to %s", self.name, path)

    @classmethod
    def load(cls, path) -> "Scene":
        from ..asset.serialize import load_asset

        kind, payload = load_asset(Path(path))
        assert kind == "scene", f"not a scene asset: {kind}"
        return cls.from_dict(payload)
