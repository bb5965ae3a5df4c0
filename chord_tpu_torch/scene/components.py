"""Scene components (port of chord_tpu/scene/components.py).

The port of the reference's component system (reference:
source/scene/component/ — Transform, GLTFMeshComponent emitting
GPUObjectGLTFPrimitive per frame, component_gltf_mesh.cpp:68-117; the
per-scene manager configs scene/manager/ — atmosphere, shadow,
post-processing). Components are plain Python dataclasses with a
serialization dict contract (to_dict/from_dict) instead of RTTR
reflection; per-frame collection is the `collect` hook.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional, TYPE_CHECKING

import numpy as np

from ..utils import math as cmath

if TYPE_CHECKING:
    from .scene import SceneNode

_COMPONENT_TYPES: Dict[str, type] = {}


def register_component(cls):
    """Type registry for serialization (the RTTR analog,
    reference: asset/reflection.h REGISTER_BODY_DECLARE)."""
    _COMPONENT_TYPES[cls.__name__] = cls
    return cls


def component_from_dict(d: Dict[str, Any]) -> "Component":
    cls = _COMPONENT_TYPES[d["type"]]
    return cls.from_dict(d)


@dataclass
class Component:
    """Base component (reference: scene/scene_common.h Component)."""

    node: Optional["SceneNode"] = field(default=None, repr=False,
                                        compare=False)

    def tick(self, dt: float) -> None:   # noqa: D401
        pass

    def collect(self, collector: "PerframeCollected",
                node_to_world: np.ndarray) -> None:
        pass

    # --- serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in asdict(self).items() if k != "node"}
        d["type"] = type(self).__name__
        return _np_to_plain(d)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Component":
        d = {k: v for k, v in d.items() if k != "type"}
        return cls(**d)


def _np_to_plain(x):
    if isinstance(x, dict):
        return {k: _np_to_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np_to_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


@register_component
@dataclass
class TransformComponent(Component):
    """Local TRS (reference: component_transform.h). Translation is f64 —
    large-world positions live on the host (SURVEY §5 long-context)."""

    translation: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    rotation: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 1.0])
    scale: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])

    def local_matrix(self) -> np.ndarray:
        return cmath.compose_trs(
            np.asarray(self.translation, np.float64),
            np.asarray(self.rotation, np.float64),
            np.asarray(self.scale, np.float64))


@register_component
@dataclass
class MeshComponent(Component):
    """References a mesh + material by asset-library key; per-frame emits
    one instance (the GLTFMeshComponent analog)."""

    mesh_key: str = ""
    material_key: str = ""

    def collect(self, collector, node_to_world) -> None:
        collector.instances.append(
            (self.mesh_key, self.material_key, node_to_world.copy()))


@register_component
@dataclass
class SkyComponent(Component):
    """Sun + atmosphere settings (reference: AtmosphereManager config)."""

    sun_direction: List[float] = field(
        default_factory=lambda: [0.3, 0.8, 0.5])
    sun_intensity: float = 8.0
    atmosphere: bool = True

    def collect(self, collector, node_to_world) -> None:
        collector.sky = self


@register_component
@dataclass
class PostProcessConfig(Component):
    """reference: PostprocessConfig render_helper.h:512-536."""

    bloom: bool = True
    bloom_intensity: float = 0.06
    auto_exposure: bool = True
    fixed_exposure: float = 1.0
    tsr: bool = True


@register_component
@dataclass
class ShadowConfigComponent(Component):
    """reference: CascadeShadowMapConfig render_helper.h:463-510."""

    enabled: bool = True
    cascade_count: int = 4
    resolution: int = 1024
    max_distance: float = 80.0


class PerframeCollected:
    """Per-camera frame collection (reference: scene/scene_common.h:54
    PerframeCollected{gltfPrimitives, asInstances, ...})."""

    def __init__(self) -> None:
        self.instances: List = []     # (mesh_key, material_key, world f64)
        self.sky: Optional[SkyComponent] = None

    def clear(self) -> None:
        self.instances.clear()
        self.sky = None
