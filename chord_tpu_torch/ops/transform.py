"""Vertex transform and object-level frustum cull of the flat frame (port
of chord_tpu/ops/transform.py; reference mesh_raster.hlsl:51-120 and
instance_culling.hlsl:48-131)."""

from __future__ import annotations

import torch

from .mesh_shader import matmul4


def transform_to_clip(positions: torch.Tensor, vertex_object: torch.Tensor,
                      object_to_tw: torch.Tensor,
                      tw_to_clip: torch.Tensor) -> torch.Tensor:
    """(V,3) object-local positions -> (V,4) clip positions through each
    vertex's object matrix (row vectors) and the view projection."""
    m = matmul4(object_to_tw, tw_to_clip)[vertex_object.long()]   # (V,4,4)
    p = positions
    return (p[:, 0, None] * m[:, 0] + p[:, 1, None] * m[:, 1] +
            p[:, 2, None] * m[:, 2] + m[:, 3])


def frustum_cull_spheres(spheres: torch.Tensor,
                         frustum_planes: torch.Tensor) -> torch.Tensor:
    """(O,4) translated-world spheres (centre, radius) vs (6,4) planes
    (dot(p, xyz) + w >= 0 inside) -> (O,) bool visible."""
    c = spheres[:, :3]
    pl = frustum_planes
    d = (c[:, 0:1] * pl[None, :, 0] + c[:, 1:2] * pl[None, :, 1] +
         c[:, 2:3] * pl[None, :, 2]) + pl[None, :, 3]
    return (d + spheres[:, 3:4] >= 0.0).all(dim=1)
