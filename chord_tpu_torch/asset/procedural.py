"""Procedural meshes + benchmark scenes (port of
chord_tpu/asset/procedural.py).

The reference demos on Sponza and Bistro, which are not redistributable,
so the benchmark runs on procedural stand-ins with matched scale:
`build_sponza_like` (an atrium, a few hundred objects) and
`build_bistro_like` (a street at Bistro scale, 2.6M+ source triangles with
`target_tris`), `build_bistro_interior` (BASELINE #4, an enclosed room lit
through one window) and `build_nanite_stress` (BASELINE #3, a field of one
high-resolution sphere). The builders are copies of chord_tpu's and draw from
`numpy.random.default_rng(seed)` in the same order, so both packages build
identical scenes from one seed. `build_bistro_like(textures=True)` adds the
bench texture pool (`bench_texture_pool`, on `builder.texture_pool`),
textured and alpha-masked materials and draws extra rng values per
building, so its materials differ from the untextured build's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..rhi.scene_arrays import MaterialData, MeshData, SceneBuilder
from ..utils import math as cmath

# --- primitives ------------------------------------------------------------

def make_plane(size: float = 1.0, segments: int = 1) -> MeshData:
    """XZ plane centered at origin, +Y normal."""
    s = segments
    xs = np.linspace(-size / 2, size / 2, s + 1)
    zs = np.linspace(-size / 2, size / 2, s + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([gx, np.zeros_like(gx), gz], -1).reshape(-1, 3)
    uv = np.stack([gx / size + 0.5, gz / size + 0.5], -1).reshape(-1, 2)
    quads = []
    for i in range(s):
        for j in range(s):
            a = i * (s + 1) + j
            b = a + 1
            c = a + (s + 1)
            d = c + 1
            quads += [[a, b, c], [b, d, c]]
    return MeshData(positions=pos.astype(np.float32),
                    indices=np.array(quads, np.int32),
                    normals=np.tile([0, 1, 0], (len(pos), 1)).astype(np.float32),
                    uv0=uv.astype(np.float32), name="plane")


def make_box(extents=(1.0, 1.0, 1.0)) -> MeshData:
    """Axis-aligned box with per-face normals (24 verts)."""
    ex, ey, ez = np.asarray(extents, np.float32) * 0.5
    faces = [
        ((+1, 0, 0), [(+ex, -ey, -ez), (+ex, +ey, -ez), (+ex, +ey, +ez), (+ex, -ey, +ez)]),
        ((-1, 0, 0), [(-ex, -ey, +ez), (-ex, +ey, +ez), (-ex, +ey, -ez), (-ex, -ey, -ez)]),
        ((0, +1, 0), [(-ex, +ey, -ez), (-ex, +ey, +ez), (+ex, +ey, +ez), (+ex, +ey, -ez)]),
        ((0, -1, 0), [(-ex, -ey, +ez), (-ex, -ey, -ez), (+ex, -ey, -ez), (+ex, -ey, +ez)]),
        ((0, 0, +1), [(-ex, -ey, +ez), (+ex, -ey, +ez), (+ex, +ey, +ez), (-ex, +ey, +ez)]),
        ((0, 0, -1), [(+ex, -ey, -ez), (-ex, -ey, -ez), (-ex, +ey, -ez), (+ex, +ey, -ez)]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, corners in faces:
        base = len(pos)
        pos += corners
        nrm += [n] * 4
        uv += [(0, 0), (1, 0), (1, 1), (0, 1)]
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return MeshData(positions=np.array(pos, np.float32),
                    indices=np.array(idx, np.int32),
                    normals=np.array(nrm, np.float32),
                    uv0=np.array(uv, np.float32), name="box")


def make_uv_sphere(radius: float = 1.0, rings: int = 16, sectors: int = 24
                   ) -> MeshData:
    phis = np.linspace(0, np.pi, rings + 1)
    thetas = np.linspace(0, 2 * np.pi, sectors + 1)
    p, t = np.meshgrid(phis, thetas, indexing="ij")
    x = np.sin(p) * np.cos(t)
    y = np.cos(p)
    z = np.sin(p) * np.sin(t)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    uv = np.stack([t / (2 * np.pi), 1 - p / np.pi], -1).reshape(-1, 2)
    idx = []
    w = sectors + 1
    for i in range(rings):
        for j in range(sectors):
            a, b = i * w + j, i * w + j + 1
            c, d = a + w, b + w
            if i > 0:
                idx.append([a, c, b])
            if i < rings - 1:
                idx.append([b, c, d])
    return MeshData(positions=(pos * radius).astype(np.float32),
                    indices=np.array(idx, np.int32),
                    normals=pos.astype(np.float32),
                    uv0=uv.astype(np.float32), name="sphere")


def make_cylinder(radius: float = 1.0, height: float = 1.0, sectors: int = 24
                  ) -> MeshData:
    thetas = np.linspace(0, 2 * np.pi, sectors + 1)
    ring = np.stack([np.cos(thetas), np.zeros_like(thetas), np.sin(thetas)], -1)
    lo = ring * radius + [0, -height / 2, 0]
    hi = ring * radius + [0, +height / 2, 0]
    pos = np.concatenate([lo, hi, [[0, -height / 2, 0]], [[0, height / 2, 0]]])
    nrm = np.concatenate([ring, ring,
                          [[0, -1, 0]], [[0, 1, 0]]])
    n = sectors + 1
    idx = []
    for j in range(sectors):
        a, b, c, d = j, j + 1, j + n, j + n + 1
        idx += [[a, c, b], [b, c, d]]
        idx += [[2 * n, b, a], [2 * n + 1, c + 0, d]]  # caps (flat-ish normals)
    uv = np.zeros((len(pos), 2), np.float32)
    return MeshData(positions=pos.astype(np.float32),
                    indices=np.array(idx, np.int32),
                    normals=nrm.astype(np.float32),
                    uv0=uv, name="cylinder")


# --- benchmark scenes ------------------------------------------------------

_PALETTE = [
    (0.78, 0.73, 0.65, 1.0), (0.62, 0.48, 0.36, 1.0), (0.70, 0.25, 0.20, 1.0),
    (0.25, 0.40, 0.55, 1.0), (0.30, 0.52, 0.28, 1.0), (0.82, 0.78, 0.70, 1.0),
    (0.45, 0.42, 0.48, 1.0), (0.85, 0.65, 0.35, 1.0),
]


def _mat(builder: SceneBuilder, rng, rough_range=(0.4, 0.95), metal_p=0.1):
    color = _PALETTE[rng.integers(len(_PALETTE))]
    metallic = 1.0 if rng.random() < metal_p else 0.0
    return builder.add_material(MaterialData(
        base_color=color, metallic=metallic,
        roughness=float(rng.uniform(*rough_range))))


def _noise2d(rng, size, octaves=4):
    """Value-noise texture in [0,1] (seeded, fast)."""
    img = np.zeros((size, size), np.float32)
    amp, cells = 1.0, 4
    for _ in range(octaves):
        g = rng.uniform(0, 1, (cells + 1, cells + 1)).astype(np.float32)
        ys = np.linspace(0, cells, size, endpoint=False)
        xs = np.linspace(0, cells, size, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        v = (g[y0][:, x0] * (1 - fy) * (1 - fx) +
             g[y0][:, x0 + 1] * (1 - fy) * fx +
             g[y0 + 1][:, x0] * fy * (1 - fx) +
             g[y0 + 1][:, x0 + 1] * fy * fx)
        img += amp * v
        amp *= 0.5
        cells *= 2
    return img / img.max()


def _height_to_normal(height: np.ndarray, strength: float = 2.0):
    """Tangent-space normal map from a height field (central differences),
    encoded [0,1] RGBA like a glTF normal texture."""
    gy, gx = np.gradient(height.astype(np.float32))
    n = np.stack([-gx * strength, gy * strength,
                  np.ones_like(height)], -1)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    out = np.ones(height.shape + (4,), np.float32)
    out[..., :3] = n * 0.5 + 0.5
    return out


def bench_texture_pool(seed: int = 5, size: int = 256):
    """Procedural texture set of the benchmark scenes: brick, plaster and
    asphalt albedo, a leaf card with alpha (the masked bucket's content),
    and a normal map and a metallic-roughness map per surface — 12 layers
    of size², drawn from their own generator (so the scene's rng is not
    consumed here)."""
    from .texture import TexturePool

    rng = np.random.default_rng(seed)
    pool = TexturePool(size)

    def rgba(rgb, a=None):
        out = np.zeros((size, size, 4), np.float32)
        out[..., :3] = rgb
        out[..., 3] = 1.0 if a is None else a
        return out

    def mr(rough, metal):
        # glTF convention: G=roughness, B=metallic
        out = np.ones((size, size, 4), np.float32)
        out[..., 1] = np.clip(rough, 0.02, 1.0)
        out[..., 2] = np.clip(metal, 0.0, 1.0)
        return out

    n = _noise2d(rng, size)
    # brick: horizontal bands + noise; mortar rows are the height valleys
    rows = (np.arange(size)[:, None] // (size // 16)) % 2
    brick = np.stack([0.45 + 0.2 * n + 0.08 * rows,
                      0.22 + 0.12 * n, 0.18 + 0.08 * n], -1)
    pool.add("bench:brick", rgba(np.clip(brick, 0, 1)))
    brick_h = 0.6 * n + 0.4 * rows
    pool.add("bench:brick_n", _height_to_normal(brick_h, 3.0))
    pool.add("bench:brick_mr", mr(0.75 + 0.2 * n, 0.0 * n))
    plaster = np.stack([0.7 + 0.2 * n] * 3, -1) * \
        np.asarray([1.0, 0.97, 0.9])
    pool.add("bench:plaster", rgba(np.clip(plaster, 0, 1)))
    pool.add("bench:plaster_n", _height_to_normal(n, 1.5))
    pool.add("bench:plaster_mr", mr(0.55 + 0.3 * n, 0.0 * n))
    asphalt = np.stack([0.18 + 0.12 * n] * 3, -1)
    pool.add("bench:asphalt", rgba(np.clip(asphalt, 0, 1)))
    pool.add("bench:asphalt_n", _height_to_normal(n, 2.0))
    # wet-spot variation: roughness dips where the noise pools
    pool.add("bench:asphalt_mr", mr(0.95 - 0.5 * (n > 0.7) * n, 0.0 * n))
    # leaf card: radial blobs with alpha holes (masked content)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size - 0.5
    rr = np.sqrt(yy * yy + xx * xx)
    alpha = ((n > 0.45) & (rr < 0.5)).astype(np.float32)
    leaf = np.stack([0.15 + 0.1 * n, 0.4 + 0.3 * n, 0.12 + 0.05 * n], -1)
    pool.add("bench:leaf", rgba(np.clip(leaf, 0, 1), alpha))
    pool.add("bench:leaf_n", _height_to_normal(n * alpha, 1.0))
    pool.add("bench:leaf_mr", mr(0.7 + 0.2 * n, 0.0 * n))
    return pool


def build_sponza_like(seed: int = 7, detail: int = 2) -> SceneBuilder:
    """Atrium scene: floor, two-story colonnade, walls. ~(detail²)·90k tris."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    floor = b.add_mesh(make_plane(1.0, segments=8 * detail))
    column = b.add_mesh(make_cylinder(0.35, 4.0, sectors=12 * detail))
    sphere = b.add_mesh(make_uv_sphere(1.0, rings=8 * detail,
                                       sectors=12 * detail))
    box = b.add_mesh(make_box())

    stone = b.add_material(MaterialData(base_color=(0.75, 0.71, 0.63, 1.0),
                                        roughness=0.85))
    fabric_r = b.add_material(MaterialData(base_color=(0.62, 0.12, 0.10, 1.0),
                                           roughness=0.9, two_sided=True))
    fabric_g = b.add_material(MaterialData(base_color=(0.12, 0.40, 0.15, 1.0),
                                           roughness=0.9, two_sided=True))

    def place(mesh, mat, t, s=(1, 1, 1), yaw=0.0):
        m = cmath.compose_trs(t, rotation_quat=(0, np.sin(yaw / 2), 0,
                                                np.cos(yaw / 2)), scale=s)
        b.add_instance(mesh, mat, m)

    # ground 40x20 atrium
    place(floor, stone, (0, 0, 0), (40, 1, 20))
    # colonnade: two stories, two rows
    for level, y in ((0, 2.0), (1, 6.2)):
        for zsign in (-1, 1):
            for i in range(10):
                x = -18 + i * 4.0
                place(column, stone, (x, y, zsign * 6.0))
        # story floor slabs
        if level == 0:
            for zsign in (-1, 1):
                place(box, stone, (0, 4.35, zsign * 6.0), (40, 0.3, 2.6))
    # perimeter walls
    for zsign in (-1, 1):
        place(box, stone, (0, 4, zsign * 9.5), (40, 8, 1))
    for xsign in (-1, 1):
        place(box, stone, (xsign * 20, 4, 0), (1, 8, 20))
    # hanging drapes
    for i in range(8):
        x = -14 + i * 4.0
        mat = fabric_r if i % 2 == 0 else fabric_g
        place(box, mat, (x, 5.0, 0.0), (0.1, 2.5, 1.6), yaw=0.3)
    # clutter spheres
    for _ in range(30 * detail):
        place(sphere, _mat(b, rng),
              (rng.uniform(-18, 18), 0.4, rng.uniform(-5, 5)),
              (0.35, 0.35, 0.35))
    return b


def build_bistro_like(seed: int = 11, detail: int = 3,
                      target_tris: Optional[int] = None,
                      textures: bool = False) -> SceneBuilder:
    """Street scene at Bistro scale (~2.8M source tris at detail=3).

    Buildings along a street, high-tessellation facades, trees with sphere
    canopies, street furniture. `target_tris` appends tessellated spheres
    until the source triangle count reaches the target.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    road = b.add_mesh(make_plane(1.0, segments=16))
    wall = b.add_mesh(make_plane(1.0, segments=12 * detail))  # tessellated facade
    box = b.add_mesh(make_box())
    ball_hi = b.add_mesh(make_uv_sphere(1.0, rings=12 * detail,
                                        sectors=16 * detail))
    trunk = b.add_mesh(make_cylinder(0.15, 3.0, sectors=8))

    tex = {k: -1 for k in ("asphalt", "brick", "plaster", "leaf",
                           "asphalt_n", "brick_n", "plaster_n", "leaf_n",
                           "asphalt_mr", "brick_mr", "plaster_mr",
                           "leaf_mr")}
    if textures:
        pool = bench_texture_pool()
        b.texture_pool = pool
        tex = {k: pool.descs[f"bench:{k}"].layer for k in tex}

    asphalt = b.add_material(MaterialData(base_color=(0.6, 0.6, 0.62, 1.0)
                                          if textures else
                                          (0.22, 0.22, 0.24, 1.0),
                                          roughness=0.95,
                                          base_color_texture=tex["asphalt"],
                                          normal_texture=tex["asphalt_n"],
                                          metal_rough_texture=tex[
                                              "asphalt_mr"]))
    bark = b.add_material(MaterialData(base_color=(0.35, 0.25, 0.15, 1.0),
                                       roughness=0.9))
    leaf = b.add_material(MaterialData(base_color=(0.6, 0.9, 0.5, 1.0)
                                       if textures else
                                       (0.20, 0.45, 0.15, 1.0),
                                       roughness=0.8,
                                       base_color_texture=tex["leaf"],
                                       normal_texture=tex["leaf_n"],
                                       metal_rough_texture=tex["leaf_mr"],
                                       alpha_mode="mask" if textures
                                       else "opaque",
                                       alpha_cutoff=0.5, two_sided=textures))

    def place(mesh, mat, t, s=(1, 1, 1), yaw=0.0, pitch=0.0):
        qy = (0, np.sin(yaw / 2), 0, np.cos(yaw / 2))
        m = cmath.compose_trs(t, rotation_quat=qy, scale=s)
        if pitch != 0.0:
            qp = (np.sin(pitch / 2), 0, 0, np.cos(pitch / 2))
            mp = cmath.compose_trs((0, 0, 0), rotation_quat=qp)
            m = mp @ m
        b.add_instance(mesh, mat, m)

    place(road, asphalt, (0, 0, 0), (120, 1, 30))

    # buildings both sides of the street
    for side in (-1, 1):
        x = -55.0
        while x < 55.0:
            w = rng.uniform(8, 14)
            h = rng.uniform(8, 18)
            d = rng.uniform(8, 12)
            z = side * (12 + d / 2)
            if textures and rng.random() < 0.7:
                kind = "brick" if rng.random() < 0.5 else "plaster"
                mat = b.add_material(MaterialData(
                    base_color=tuple(rng.uniform(0.7, 1.0, 3)) + (1.0,),
                    roughness=float(rng.uniform(0.5, 0.9)),
                    base_color_texture=tex[kind],
                    normal_texture=tex[f"{kind}_n"],
                    metal_rough_texture=tex[f"{kind}_mr"]))
            else:
                mat = _mat(b, rng, rough_range=(0.5, 0.9))
            place(box, mat, (x + w / 2, h / 2, z), (w, h, d))
            # facade detail: tessellated wall quad facing the street
            place(wall, mat, (x + w / 2, h / 2, side * 11.95),
                  (w * 0.98, 1, h * 0.98), pitch=-side * np.pi / 2)
            # awning
            if rng.random() < 0.6:
                place(box, _mat(b, rng), (x + w / 2, 3.0, side * 10.8),
                      (w * 0.7, 0.1, 2.0), pitch=side * 0.3)
            # shop window: translucent glass pane (Blend bucket)
            if rng.random() < 0.5:
                glass = b.add_material(MaterialData(
                    base_color=(0.45, 0.62, 0.78, 0.35),
                    roughness=0.08, two_sided=True, alpha_mode="blend"))
                place(wall, glass, (x + w / 2, 2.2, side * 11.5),
                      (w * 0.5, 1, 3.2), pitch=-side * np.pi / 2)
            x += w + rng.uniform(1, 3)

    # trees along the street
    for x in np.arange(-50, 51, 8.0):
        for side in (-1, 1):
            z = side * 8.0
            place(trunk, bark, (x, 1.5, z))
            place(ball_hi, leaf, (x, 4.0, z),
                  tuple(rng.uniform(1.2, 1.8, 3)))

    # street furniture
    for _ in range(40):
        place(box, _mat(b, rng),
              (rng.uniform(-55, 55), 0.5, rng.uniform(-6, 6)),
              tuple(rng.uniform(0.4, 1.2, 3)), yaw=rng.uniform(0, np.pi))

    if target_tris is not None:
        deficit = target_tris - sum(
            b.meshes[m].num_triangles for m, _, _ in
            ((mi, ma, tr) for mi, ma, tr in b.instances))
        while deficit > 0:
            s = (rng.uniform(0.5, 1.5),) * 3
            place(ball_hi, _mat(b, rng),
                  (rng.uniform(-55, 55), rng.uniform(1, 10),
                   rng.uniform(-25, 25)), s)
            deficit -= b.meshes[ball_hi].num_triangles
    return b

def build_bistro_interior(seed: int = 5, detail: int = 2) -> SceneBuilder:
    """Indoor GI scene (BASELINE config #4: "Bistro indoor with
    screen-probe diffuse GI"): an enclosed room lit only through a
    window opening — most of the room sees NO direct sun, so visible
    light there is the GI path's bounce (world cache + screen probes).
    Strongly colored side walls make the bounce tint measurable
    (Cornell-box style color bleeding)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    plane = b.add_mesh(make_plane(1.0, segments=6 * detail))
    box = b.add_mesh(make_box())
    sphere = b.add_mesh(make_uv_sphere(1.0, rings=8 * detail,
                                       sectors=12 * detail))
    column = b.add_mesh(make_cylinder(0.3, 4.0, sectors=10 * detail))

    plaster = b.add_material(MaterialData(base_color=(0.82, 0.80, 0.75, 1.0),
                                          roughness=0.9))
    wood = b.add_material(MaterialData(base_color=(0.45, 0.30, 0.18, 1.0),
                                       roughness=0.7))
    red = b.add_material(MaterialData(base_color=(0.70, 0.08, 0.06, 1.0),
                                      roughness=0.9))
    green = b.add_material(MaterialData(base_color=(0.08, 0.55, 0.10, 1.0),
                                        roughness=0.9))
    brass = b.add_material(MaterialData(base_color=(0.85, 0.65, 0.25, 1.0),
                                        roughness=0.35, metallic=1.0))

    def place(mesh, mat, t, s=(1, 1, 1), yaw=0.0):
        m = cmath.compose_trs(t, rotation_quat=(0, np.sin(yaw / 2), 0,
                                                np.cos(yaw / 2)), scale=s)
        b.add_instance(mesh, mat, m)

    # room shell: 16 x 5 x 10 (x, y, z), open along +x where the window
    # wall has a large opening for the sun shaft
    place(plane, wood, (0, 0, 0), (16, 1, 10))             # floor
    place(box, plaster, (0, 5.15, 0), (16, 0.3, 10))       # ceiling
    place(box, red, (0, 2.5, -5.15), (16, 5, 0.3))         # back wall
    place(box, green, (-8.15, 2.5, 0), (0.3, 5, 10))       # left wall
    place(box, plaster, (0, 2.5, 5.15), (16, 5, 0.3))      # front wall
    # window wall (+x): sill, header and two piers leaving a 4x2.6 opening
    place(box, plaster, (8.15, 0.6, 0), (0.3, 1.2, 10))    # sill
    place(box, plaster, (8.15, 4.4, 0), (0.3, 1.2, 10))    # header
    place(box, plaster, (8.15, 2.5, -3.6), (0.3, 5, 2.8))  # pier -z
    place(box, plaster, (8.15, 2.5, 3.6), (0.3, 5, 2.8))   # pier +z

    # furniture: tables, columns, props
    for i in range(3):
        x = -5.0 + i * 4.0
        place(box, wood, (x, 0.9, -1.5), (1.6, 0.12, 1.0))    # table top
        place(box, wood, (x, 0.45, -1.5), (0.15, 0.9, 0.15))  # leg
        place(sphere, brass, (x, 1.2, -1.5), (0.25, 0.25, 0.25))
    for zs in (-3.5, 3.5):
        place(column, plaster, (-6.5, 2.0, zs))
    for _ in range(10 * detail):
        place(sphere, _mat(b, rng),
              (rng.uniform(-7, 7), 0.3, rng.uniform(-4, 4)),
              (0.25, 0.25, 0.25))
    return b


def build_nanite_stress(seed: int = 3, spheres: int = 100,
                        rings: int = 64) -> SceneBuilder:
    """Nanite stress scene (BASELINE config #3: cluster-LOD selection +
    software raster under fly-through): a field of high-resolution
    spheres — ~2*rings^2 source triangles each, one shared mesh whose
    full LOD DAG the runtime cut selects per instance by screen size.
    Source triangle count scales ~spheres * 2 * rings^2 (100 spheres at
    rings=64 ≈ 1.6M) while DRAWN triangles stay roughly constant."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    sph = b.add_mesh(make_uv_sphere(1.0, rings=rings, sectors=2 * rings))
    floor = b.add_mesh(make_plane(1.0, segments=8))
    stone = b.add_material(MaterialData(base_color=(0.7, 0.68, 0.62, 1.0),
                                        roughness=0.9))
    mats = [b.add_material(MaterialData(
        base_color=(float(c[0]), float(c[1]), float(c[2]), 1.0),
        roughness=float(r), metallic=float(m)))
        for c, r, m in zip(rng.uniform(0.2, 0.9, (8, 3)),
                           rng.uniform(0.2, 0.9, 8),
                           rng.uniform(0.0, 0.8, 8))]
    m = cmath.compose_trs((0, 0, 0), scale=(120, 1, 120))
    b.add_instance(floor, stone, m)
    side = int(np.ceil(np.sqrt(spheres)))
    for i in range(spheres):
        gx, gz = i % side, i // side
        t = (gx * 6.0 - side * 3.0 + rng.uniform(-1, 1),
             1.0 + rng.uniform(0.0, 2.5),
             gz * 6.0 - side * 3.0 + rng.uniform(-1, 1))
        s = rng.uniform(0.6, 1.8)
        b.add_instance(sph, mats[i % len(mats)],
                       cmath.compose_trs(t, scale=(s, s, s)))
    return b
