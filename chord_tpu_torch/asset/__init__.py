from .procedural import (  # noqa: F401
    bench_texture_pool, build_bistro_interior, build_bistro_like,
    build_nanite_stress, build_sponza_like, make_box, make_cylinder,
    make_plane, make_uv_sphere,
)
from .texture import TexturePool, build_mips  # noqa: F401
from .gltf import load_gltf, GLTFScene  # noqa: F401
