from .procedural import (  # noqa: F401
    build_bistro_like, build_sponza_like, make_box, make_cylinder,
    make_plane, make_uv_sphere,
)
