from .framebuffer import FrameHistory  # noqa: F401
from .meshlet_scene import MeshletScenePools, build_meshlet_pools  # noqa: F401
from .scene_arrays import (FrameInstances, MaterialData, MeshData,  # noqa: F401
                           SceneBuilder)
