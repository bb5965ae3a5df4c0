"""chord_tpu_torch — the PyTorch + CUDA port of chord_tpu.

chord_tpu (the JAX package beside this one) is the reference: every module
here carries the name of its counterpart there, and the tests hold the two
against each other on the same inputs. This package imports torch and
never jax.

What is ported is the GPU-driven meshlet frame of the four
benchmark rungs: `off` (object pre-cull, two-phase HZB occlusion culling
with the Nanite LOD cut, the mesh-shader setup, the tiled visibility
raster, the g-buffer resolve, sun + ambient lighting, auto exposure,
tile-mode TSR upscale, bloom and the ACES tonemap), `geo_tex` (material
maps from the paged texture pool, the alpha-masked and blend buckets),
`geo_shadow_atmo` (cascaded shadow maps with PCSS and a temporal mask,
the physically based sky and aerial perspective) and `all` (screen-probe
GI with BVH rays over bounding-sphere proxies, SSAO, SSR and the specular
chain), with every other branch of that frame (among them the pipelined
shadow split, DDGI, triangle-exact BVH leaves, RTAO and the probe march);
the flat DeferredRenderer frame; the host layers a user brings a scene
through (glTF / PMX import, the .chtp asset container and manager, the
scene graph and SceneSubsystem); the viewer and the editor
(`python -m chord_tpu_torch.apps.viewer`, `... .apps.editor`); two of
chord_tpu's tools; the strip-parallel frame on torch.distributed (one
process a strip, `parallel/`); the job system, the name table and the
stable hashes, and every cvar chord_tpu registers. The port does all
that chord_tpu does.

Every Pallas kernel on those paths is a hand-written CUDA kernel for sm_90a
(`csrc/`, built with nvcc at first use into `build/` and loaded with
ctypes). Each kernel's wrapper sits beside a plain PyTorch version of the
same function: a tensor on the CPU takes the plain version, a CUDA tensor
launches the kernel.

Layout (mirrors chord_tpu):
    utils/     cvars, logging (taps, file sink), events, timers, math,
               camera, span and slot allocators, names and stable hashes,
               the strip frame's collectives
    native/    ctypes binding to the shared native/ C++ library (Nanite
               and BVH builders, the job system)
    geometry/  meshlet clustering (host)
    rhi/       scene builder, meshlet pools, frame history
    asset/     procedural benchmark scenes, texture pool, glTF and PMX
               importers, the .chtp container, the asset manager
    scene/     scene graph, components, SceneSubsystem
    ops/       cull, hzb, mesh shader, raster, row gather, textures,
               shading, shadows + PCSS, atmosphere, GI, BVH rays, post
    renderer/  the meshlet frame, the flat frame, the sequence runner,
               MeshletRenderer
    parallel/  strip-parallel frames: ShardedRenderer, spawn_strips
    apps/      the headless viewer and the scene editor
    tools/     the paged-texture prototype (kernel K10) and the shadow
               evaluate fault bisection (kernel K9)
    interop.py numpy state from chord_tpu -> this package's tensors
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry math (vertex transforms, colour matrices, edge equations) needs
# true f32, as chord_tpu forces "highest" matmul precision
# (chord_tpu/__init__.py:42): keep TF32 off for matmuls and convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
