from .meshlet import MeshletData, build_meshlets  # noqa: F401
