"""Host-side math (a copy of chord_tpu/utils/math.py): projection/view matrices, frustum planes, Halton jitter.

Conventions (documented once, used everywhere):
- Right-handed world, +Y up. View space looks down -Z (OpenGL-style).
- Clip space: x,y in [-w,w], z in [0,w] with **reverse-Z**: z_ndc = 1 at the
  near plane, 0 at infinity. Reverse-Z + fp32 gives near-uniform depth
  precision which the software rasterizer's depth test depends on; the depth
  test keeps the *larger* value. (The reference uses Vulkan reverse-Z with
  zNear 0.001 / an effectively-infinite far — utils/camera.h:107-110.)
- Screen space: pixel (0,0) is top-left; +x right, +y down.
- Matrices are row-vector convention: p_clip = p_world @ M, with M stored
  (4,4) so composition reads left-to-right: world→view→clip = V @ P.

Host math uses numpy float64 (large-world positions, reference:
utils/camera.h:100 `math::dvec3 m_position`); everything shipped to the
device is float32 in camera-relative "translated world" space, matching the
reference's translatedWorld* naming scheme (shader/base.h:292-341).
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """World→view matrix (row-vector convention), f64."""
    eye = np.asarray(eye, np.float64)
    f = normalize(np.asarray(center, np.float64) - eye)     # forward
    s = normalize(np.cross(f, np.asarray(up, np.float64)))  # right
    u = np.cross(s, f)                                      # true up
    m = np.eye(4, dtype=np.float64)
    # Columns of the rotation block map world axes onto (right, up, -fwd).
    m[:3, 0] = s
    m[:3, 1] = u
    m[:3, 2] = -f
    m[3, 0] = -np.dot(eye, s)
    m[3, 1] = -np.dot(eye, u)
    m[3, 2] = np.dot(eye, f)
    return m


def perspective_reverse_z(fovy_rad: float, aspect: float, z_near: float) -> np.ndarray:
    """Infinite-far reverse-Z perspective (row-vector convention).

    z_clip = z_near * (-1/z_view) * w ... mapping z_view=-near -> ndc 1,
    z_view=-inf -> ndc 0.
    """
    f = 1.0 / np.tan(fovy_rad * 0.5)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = 0.0
    m[2, 3] = -1.0
    m[3, 2] = z_near
    return m


def ortho_reverse_z(l: float, r: float, b: float, t: float,
                    z_near: float, z_far: float) -> np.ndarray:
    """Orthographic reverse-Z (used by shadow cascades)."""
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = 2.0 / (r - l)
    m[1, 1] = 2.0 / (t - b)
    m[2, 2] = 1.0 / (z_far - z_near)   # maps -z_near -> 1, -z_far -> 0
    m[3, 0] = -(r + l) / (r - l)
    m[3, 1] = -(t + b) / (t - b)
    m[3, 2] = z_far / (z_far - z_near)
    return m


def frustum_planes(view_proj: np.ndarray) -> np.ndarray:
    """Extract frustum planes from a row-vector view-proj matrix.

    Returns (P,4) with plane eq dot(p,xyz)+w >= 0 for inside. Gribb-Hartmann
    adapted to row-vector convention (planes are columns combinations).
    Reverse-Z infinite-far yields 5 planes (no far); a zero far row is
    dropped, so output is (5,4) or (6,4), padded to (6,4) with an
    always-true plane for static shapes.
    """
    m = view_proj
    c0, c1, c2, c3 = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    planes = [
        c3 + c0,   # left
        c3 - c0,   # right
        c3 + c1,   # bottom
        c3 - c1,   # top
        c2,        # near (z >= 0 in clip, reverse-Z)
        c3 - c2,   # far  (z <= w)
    ]
    out = []
    for p in planes:
        n = np.linalg.norm(p[:3])
        if n < 1e-12:
            # degenerate (infinite far): always-true plane
            out.append(np.array([0.0, 0.0, 0.0, 1.0]))
        else:
            out.append(p / n)
    return np.stack(out).astype(np.float64)


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence member (reference: renderer.cpp:34-39
    uses Halton(2,3) for TSR jitter)."""
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton23_jitter(frame_index: int, phase_count: int) -> np.ndarray:
    """Sub-pixel jitter in [-0.5, 0.5)^2."""
    i = (frame_index % phase_count) + 1
    return np.array([halton(i, 2) - 0.5, halton(i, 3) - 0.5], dtype=np.float64)


def compose_trs(translation, rotation_quat=None, scale=None) -> np.ndarray:
    """TRS → 4x4 row-vector matrix (glTF node transforms)."""
    t = np.asarray(translation, np.float64)
    s = np.ones(3) if scale is None else np.asarray(scale, np.float64)
    if rotation_quat is None:
        r = np.eye(3)
    else:
        x, y, z, w = np.asarray(rotation_quat, np.float64)
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
            [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
            [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
        ])
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = (np.diag(s) @ r)
    m[3, :3] = t
    return m


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Row-vector point transform: (N,3) @ (4,4) -> (N,3) (w divide)."""
    h = np.concatenate([pts, np.ones((pts.shape[0], 1), pts.dtype)], axis=1)
    out = h @ m
    return out[:, :3] / out[:, 3:4]


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the 3x3 block for normal transforms."""
    return np.linalg.inv(m[:3, :3]).T
