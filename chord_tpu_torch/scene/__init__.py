from .scene import Scene, SceneNode  # noqa: F401
from .components import (  # noqa: F401
    Component, TransformComponent, MeshComponent, SkyComponent,
    PostProcessConfig, ShadowConfigComponent)
from .subsystem import SceneSubsystem  # noqa: F401
