"""Debug line rendering (ops/debug_draw.py) against chord_tpu's.

The segment builders are host numpy in both packages and must match
exactly. project_segments and overlay_lines run on seeded inputs: a few
hundred segments (not a multiple of the 32-segment chunk), some behind the
camera. Tolerances: projected endpoints within 1e-5 relative, 1e-3 px
absolute near the origin (a divide by w and a 4x4 product, summed in
another order); the overlay within 1e-5
absolute on values in [0, 1] (a sqrt of the least squared distance, the
same minimum over the chunks).
"""

import jax.numpy as jnp
import numpy as np
import torch

from chord_tpu.ops import debug_draw as jdd

from chord_tpu_torch.ops import debug_draw as dd


def _view(w, h):
    """A row-vector perspective projection looking down -z."""
    f, n = 1.0 / np.tan(0.6), 0.05
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 3], m[3, 2] = f * h / w, f, -1.0, n
    return m


def test_segment_builders_match():
    np.testing.assert_array_equal(dd.aabb_segments((-1, 0, -2), (2, 3, 1)),
                                  jdd.aabb_segments((-1, 0, -2), (2, 3, 1)))
    for segs in (24, 7):
        np.testing.assert_array_equal(
            dd.sphere_segments((1.0, 2.0, -5.0), 1.5, segs),
            jdd.sphere_segments((1.0, 2.0, -5.0), 1.5, segs))
    assert dd.aabb_segments((0, 0, 0), (1, 1, 1)).shape == (12, 2, 3)
    assert dd.sphere_segments((0, 0, 0), 1.0).shape == (72, 2, 3)


def test_project_and_overlay_match():
    rng = np.random.default_rng(29)
    w, h = 160, 96
    m = _view(w, h)
    boxes = [dd.aabb_segments(c - 1.0, c + 1.0) for c in
             rng.uniform([-6, -3, -20], [6, 3, -4], (12, 3))]
    spheres = [dd.sphere_segments(c, 0.8) for c in
               rng.uniform([-6, -3, -20], [6, 3, 2], (4, 3))]
    segs = np.concatenate(boxes + spheres).astype(np.float32)
    assert segs.shape[0] % dd.CHUNK
    ref_px, ref_ok = jdd.project_segments(jnp.asarray(segs), jnp.asarray(m),
                                          w, h)
    px, ok = dd.project_segments(torch.from_numpy(segs), torch.from_numpy(m),
                                 w, h)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert 0 < int(ok.sum()) < segs.shape[0]      # some lie behind
    ref_px = np.array(ref_px)
    np.testing.assert_allclose(px.numpy()[ok.numpy()],
                               ref_px[np.asarray(ref_ok)], rtol=1e-5,
                               atol=1e-3)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    # both overlays from the same endpoints, with and without `valid`
    for valid in (None, ok):
        ref = jdd.overlay_lines(
            jnp.asarray(img), jnp.asarray(ref_px),
            None if valid is None else jnp.asarray(valid.numpy()),
            color=(1.0, 0.2, 0.1), width_px=1.5)
        got = dd.overlay_lines(torch.from_numpy(img),
                               torch.from_numpy(ref_px), valid,
                               color=(1.0, 0.2, 0.1), width_px=1.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        assert (np.abs(got.numpy() - img) > 0.1).mean() > 0.01
