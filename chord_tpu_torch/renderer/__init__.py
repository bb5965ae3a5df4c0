from .deferred import DeviceView, RendererConfig  # noqa: F401
from .meshlet_frame import (MeshletFrameConfig, MeshletRenderer,  # noqa: F401
                            render_frame_meshlet, render_sequence_meshlet)
