"""chord_tpu_torch — the PyTorch + CUDA port of chord_tpu.

chord_tpu (the JAX package beside this one) is the reference: every module
here carries the name of its counterpart there, and the tests hold the two
against each other on the same inputs. This package imports torch and
never jax.

What is ported so far is the GPU-driven meshlet frame with every optional
feature off (the benchmark's `off` rung): object pre-cull, two-phase HZB
occlusion culling with the Nanite LOD cut, the mesh-shader setup, the tiled
visibility raster, the g-buffer resolve, sun + ambient lighting, auto
exposure, tile-mode TSR upscale, bloom and the ACES tonemap.

Every Pallas kernel on that path is a hand-written CUDA kernel for sm_90a
(`csrc/`, built with nvcc at first use into `build/` and loaded with
ctypes). Each kernel's wrapper sits beside a plain PyTorch version of the
same function: a tensor on the CPU takes the plain version, a CUDA tensor
launches the kernel.

Layout (mirrors chord_tpu):
    utils/     cvars, logging, math, camera, span allocator
    native/    ctypes binding to the shared native/ C++ library
    geometry/  meshlet clustering (host)
    rhi/       scene builder, meshlet pools, frame history
    asset/     procedural benchmark scenes
    ops/       cull, hzb, mesh shader, raster, row gather, shading, post
    renderer/  the meshlet frame, the sequence runner, MeshletRenderer
    interop.py numpy state from chord_tpu -> this package's tensors
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry math (vertex transforms, colour matrices, edge equations) needs
# true f32, as chord_tpu forces "highest" matmul precision
# (chord_tpu/__init__.py:42): keep TF32 off for matmuls and convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
