from .deferred import (DeferredRenderer, DeviceView,  # noqa: F401
                       RendererConfig, render_frame_flat)
from .meshlet_frame import (MeshletFrameConfig, MeshletRenderer,  # noqa: F401
                            render_frame_meshlet, render_sequence_meshlet,
                            render_sequence_split, shadow_pipelined,
                            shadow_service_step)
