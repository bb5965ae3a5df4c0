"""The port's shadow ops against chord_tpu's, on the same seeded inputs.

Covers ops/shadow.py (host and device cascade fits, the PCSS prepass and
evaluate_shadow, the plain version of kernel K6), ops/hzb.py's
valid_depth_range, DeviceView.from_uniform(shadow_cfg=...) and the frame's
render_shadow_cascade (full and scrolled refresh, alpha-tested masked
casters) at R=256. chord_tpu's Pallas kernels run in interpret mode.

Tolerances, with their reasons:
- fit_cascades and DeviceView: the same numpy arithmetic -> exact.
- fit_cascades_device: f32 on both sides, but XLA contracts a*b+c into
  FMAs and orders its dots and means its own way: 2e-6 relative and
  absolute on matrices and planes (one texel at R=256 is 8e-3 NDC, so a
  texel-snap flip would show).
- valid_depth_range: a max, a min and an IEEE divide -> exact.
- evaluate_shadow vs chord_tpu's: the receivers' light-space coordinates
  round differently under XLA's FMAs, which can move a PCSS tap across a
  texel edge: >= 99.9% of pixels exact, every pixel within one PCF sample
  (1/6).
- vs evaluate_shadow_pallas in its exact regime (one cascade, level 0):
  1e-5, as tests/test_shadow.py:249-267 holds chord_tpu's two paths.
- render_shadow_cascade, end to end: coverage (depth > 0) equal on >= 99.9%
  of texels, depth within ShadowConfig.depth_bias (2e-4) on >= 99.9% and
  within 1e-3 everywhere. Each package computes its own mesh-shader setup;
  XLA's FMAs move its plane coefficients by <= 7e-7 relative, and the
  homogeneous depth divide amplifies that to <= 1.8e-4 in [0,1]
  light-space depth (measured here). Fed chord_tpu's own setup, the
  port's depth-only raster meets the raster bound of test_torch_raster.py
  (1e-6; measured 1.8e-7): test_shadow_raster_on_the_reference_setup.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chord_tpu.asset.procedural as jproc
import chord_tpu.asset.texture as jtex
import chord_tpu.ops.shadow as jshadow
import chord_tpu.rhi.scene_arrays as jsa
import chord_tpu.utils.math as jmath
from chord_tpu.ops import cull as jcull
from chord_tpu.ops import mesh_shader as jms
from chord_tpu.ops import raster as jr
from chord_tpu.ops.hzb import valid_depth_range as jax_depth_range
from chord_tpu.ops.shadow_kernel import evaluate_shadow_pallas
from chord_tpu.renderer.deferred import DeviceView as JView
from chord_tpu.renderer.deferred import RendererConfig as JConfig
from chord_tpu.renderer.meshlet_frame import MeshletFrameConfig as JMcfg
from chord_tpu.renderer.meshlet_frame import \
    render_shadow_cascade as jax_cascade
from chord_tpu.rhi.meshlet_scene import build_meshlet_pools as jax_pools
from chord_tpu.utils.camera import Camera as JCamera

import chord_tpu_torch.asset.procedural as proc
import chord_tpu_torch.asset.texture as tex
import chord_tpu_torch.rhi.scene_arrays as sa
from chord_tpu_torch import interop
from chord_tpu_torch.ops import kernels, raster, shadow
from chord_tpu_torch.ops.hzb import valid_depth_range
from chord_tpu_torch.renderer import (DeviceView, MeshletFrameConfig,
                                      RendererConfig)
from chord_tpu_torch.renderer.meshlet_frame import render_shadow_cascade
from chord_tpu_torch.rhi.meshlet_scene import build_meshlet_pools
from chord_tpu_torch.utils import math as tmath
from chord_tpu_torch.utils.camera import Camera
from test_torch_frame_tex import CFG, MCFG, build_textured_scene

t_ = lambda a: torch.from_numpy(np.array(a, np.float32))


def _fit_inputs(seed):
    rng = np.random.default_rng(seed)
    fwd = rng.normal(size=3) * np.array([1.0, 0.3, 1.0])
    sun = rng.normal(size=3) * 0.3 + np.array([0.3, 0.8, 0.5])
    return fwd / np.linalg.norm(fwd), sun / np.linalg.norm(sun)


@pytest.mark.parametrize("casc", [1, 4])
def test_fit_cascades_matches(casc):
    fwd, sun = _fit_inputs(casc)
    cfg = dict(cascade_count=casc, resolution=512)
    ref = jshadow.fit_cascades(fwd, sun, np.radians(55.0), 16 / 9,
                               jshadow.ShadowConfig(**cfg))
    got = shadow.fit_cascades(fwd, sun, np.radians(55.0), 16 / 9,
                              shadow.ShadowConfig(**cfg))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scroll, z_range, seed", [
    (False, (0.1, 80.0), 0), (False, (2.5, 31.0), 1),
    (True, (0.1, 1e9), 2), (True, (1.41421354, 45.254833), 3)])
def test_fit_cascades_device_matches(scroll, z_range, seed):
    """Both fits, the scrolled cache's z quantization (radius/2 steps of
    the light eye, 6-radius depth span) included."""
    fwd, sun = _fit_inputs(seed)
    tan_y = np.float32(np.tan(np.radians(30.0)))
    tan_x = np.float32(tan_y * 16 / 9)
    cfg = dict(cascade_count=4, resolution=256, scroll=scroll)
    j_mats, j_planes = jshadow.fit_cascades_device(
        jnp.asarray(fwd, jnp.float32), jnp.asarray(sun, jnp.float32),
        jnp.float32(tan_x), jnp.float32(tan_y),
        jnp.asarray(z_range, jnp.float32), jshadow.ShadowConfig(**cfg))
    mats, planes = shadow.fit_cascades_device(
        t_(fwd), t_(sun), t_(tan_x), t_(tan_y), t_(z_range),
        shadow.ShadowConfig(**cfg))
    np.testing.assert_allclose(mats.numpy(), np.asarray(j_mats), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(planes.numpy(), np.asarray(j_planes),
                               rtol=2e-6, atol=2e-6)
    if scroll:
        # z row: tz quantized, so m[3,2] = tz*zr + 1 sits on the step grid
        np.testing.assert_allclose(mats.numpy()[:, 3, 2],
                                   np.asarray(j_mats)[:, 3, 2], atol=1e-6)


def test_valid_depth_range_matches():
    rng = np.random.default_rng(4)
    depth = rng.uniform(1e-4, 0.9, (64, 128)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    for d in (depth, np.zeros_like(depth)):
        ref = np.asarray(jax_depth_range(jnp.asarray(d), jnp.float32(0.01)))
        got = valid_depth_range(torch.from_numpy(d), t_(0.01))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_device_view_shadow_fields_match():
    cams = []
    for cls in (JCamera, Camera):
        cam = cls(width=128, height=64)
        cam.position = np.array([-3.0, 2.0, 5.0])
        cam.look_at(np.array([2.0, 1.0, -4.0]))
        cams.append(cam)
    jcfg = jshadow.ShadowConfig(cascade_count=3)
    ref = JView.from_uniform(cams[0].view_uniform(2), shadow_cfg=jcfg)
    got = DeviceView.from_uniform(cams[1].view_uniform(2), device="cpu",
                                  shadow_cfg=shadow.ShadowConfig(
                                      cascade_count=3))
    names = ("shadow_tw_to_light", "shadow_frustum_planes", "shadow_splits",
             "view_forward", "tan_half_fov", "z_near", "cam_world_y")
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # interop carries chord_tpu's stacked view across, each LUT once
    lut = np.random.default_rng(8).uniform(size=(32, 32, 3)).astype(
        np.float32)
    ref = ref.replace(atmo_t_lut=jnp.asarray(lut), atmo_ms_lut=jnp.asarray(
        lut), atmo_sky_lut=jnp.asarray(lut))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), ref, ref)
    arrays = {k: np.asarray(v) for k, v in vars(stacked).items()
              if v is not None}
    view = interop.view_from_numpy(arrays, device="cpu")
    for name in names:
        np.testing.assert_array_equal(getattr(view.frame(1), name).numpy(),
                                      arrays[name][1], err_msg=name)
    for name in ("atmo_t_lut", "atmo_ms_lut", "atmo_sky_lut"):
        assert tuple(getattr(view, name).shape) == (32, 32, 3)
        np.testing.assert_array_equal(getattr(view.frame(1), name).numpy(),
                                      lut)


def _occluder_setup(res=256, casc=1):
    """tests/test_shadow.py's scene: straight-down sun, an occluder quad
    at y=5 over x,z in [-5,0] splatted into every cascade."""
    cfg = dict(cascade_count=casc, resolution=res, max_distance=40.0,
               light_size_world=0.5)
    sun = np.array([0.0, 1.0, 0.0])
    mats, _ = jshadow.fit_cascades(np.array([0.0, 0.0, -1.0]), sun,
                                   np.radians(60.0), 1.0,
                                   jshadow.ShadowConfig(**cfg))
    maps = np.zeros((casc, res, res), np.float32)
    quad = np.array([[-5.0, 5.0, -5.0], [0.0, 5.0, -5.0],
                     [0.0, 5.0, 0.0], [-5.0, 5.0, 0.0]])
    for c in range(casc):
        clip = (np.concatenate([quad, np.ones((4, 1))], 1)
                @ mats[c].astype(np.float64))
        uv = np.stack([(clip[:, 0] * 0.5 + 0.5) * res,
                       (0.5 - clip[:, 1] * 0.5) * res], 1)
        x0, x1 = int(uv[:, 0].min()), int(np.ceil(uv[:, 0].max()))
        y0, y1 = int(uv[:, 1].min()), int(np.ceil(uv[:, 1].max()))
        maps[c, max(y0, 0):y1, max(x0, 0):x1] = clip[:, 2].mean()
    return cfg, sun.astype(np.float32), mats, maps


def _receivers(h, w, span, seed):
    """A ground grid with a random height field and tilted normals."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((h, w, 3), np.float32)
    pos[..., 0] = np.linspace(-span, span, w)[None, :]
    pos[..., 2] = np.linspace(-span, span, h)[:, None]
    pos[..., 1] = rng.uniform(0.0, 0.3, (h, w))
    nrm = rng.normal(size=(h, w, 3)) * 0.3 + np.array([0.0, 1.0, 0.0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    noise = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    return pos, nrm.astype(np.float32), noise


def _both(cfg, sun, mats, maps, pos, nrm, noise):
    """-> (port evaluate_shadow, chord_tpu evaluate_shadow) as numpy."""
    j = jshadow.evaluate_shadow(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(sun),
        jnp.asarray(maps), jnp.asarray(mats), jshadow.ShadowConfig(**cfg),
        noise=None if noise is None else jnp.asarray(noise))
    p = shadow.evaluate_shadow(
        t_(pos), t_(nrm), t_(sun), t_(maps), t_(mats),
        shadow.ShadowConfig(**cfg),
        noise=None if noise is None else t_(noise))
    return p.numpy(), np.asarray(j)


@pytest.mark.parametrize("casc", [1, 4])
@pytest.mark.parametrize("with_noise", [False, True])
def test_evaluate_shadow_matches(casc, with_noise):
    cfg, sun, mats, maps = _occluder_setup(casc=casc)
    pos, nrm, noise = _receivers(64, 96, 9.0, casc)
    got, ref = _both(cfg, sun, mats, maps, pos, nrm,
                     noise if with_noise else None)
    assert (ref < 0.5).mean() > 0.02 and (ref > 0.99).mean() > 0.2
    assert (got == ref).mean() >= 0.999, (got != ref).mean()
    assert np.abs(got - ref).max() <= 1 / 6 + 1e-6


def test_evaluate_shadow_matches_pallas_exact_regime():
    """Single cascade, every tile at pyramid level 0: the Pallas kernel is
    tap-exact against the per-pixel function, and so is the port."""
    cfg, sun, mats, maps = _occluder_setup(casc=1)
    pos, nrm, noise = _receivers(64, 96, 7.0, 5)
    pos[..., 1] = 0.0
    nrm[:] = (0.0, 1.0, 0.0)
    ref = np.asarray(evaluate_shadow_pallas(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(sun),
        jnp.asarray(maps), jnp.asarray(mats), jshadow.ShadowConfig(**cfg),
        noise=jnp.asarray(noise), interpret=True))
    got = shadow.evaluate_shadow(t_(pos), t_(nrm), t_(sun), t_(maps),
                                 t_(mats), shadow.ShadowConfig(**cfg),
                                 noise=t_(noise)).numpy()
    assert (ref < 0.5).mean() > 0.02
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_evaluate_shadow_auto_is_the_plain_version_on_the_cpu():
    """On CPU tensors the frame's dispatch (prepass + K6's wrapper) is
    evaluate_shadow exactly, eval_kernel=False included; K6's registry
    entry names the plain half."""
    cfg, sun, mats, maps = _occluder_setup(casc=4)
    pos, nrm, noise = _receivers(32, 48, 9.0, 6)
    args = (t_(pos), t_(nrm), t_(sun), t_(maps), t_(mats))
    ref = shadow.evaluate_shadow(*args, shadow.ShadowConfig(**cfg),
                                 noise=t_(noise))
    for ek in (None, False):
        got = shadow.evaluate_shadow_auto(
            *args, shadow.ShadowConfig(**cfg, eval_kernel=ek),
            noise=t_(noise))
        assert torch.equal(got, ref)
    k6 = {k.name: k for k in kernels.KERNELS}["pcss"]
    assert k6.plain is shadow.pcss_plain and k6.paths == ("geo_shadow_atmo",
                                                          "all_no_rt")


# --- render_shadow_cascade ----------------------------------------------------

R = 256
SCFG = dict(cascade_count=1, resolution=R)
# the masked leaf cards cast alpha-tested shadows (shadow_masked)
CASCADE_MCFG = dict(MCFG, shadows=True)


@functools.partial(jax.jit, static_argnames=("rc", "mcfg"))
def _jax_refresh(pools, inst, mats, planes, prev_map, prev_mat, prev_valid,
                 rc, mcfg):
    return jax_cascade(pools, inst, None, rc, mcfg, jnp.int32(0),
                       mats=mats, planes_all=planes, prev_map=prev_map,
                       prev_mat=prev_mat, prev_valid=prev_valid)


def _planes(m):
    return np.stack([tmath.frustum_planes(m.astype(np.float64))]
                    ).astype(np.float32)


@pytest.fixture(scope="module")
def cascades():
    return _render_cascades(CASCADE_MCFG)


def _render_cascades(mcfg_fields):
    """Cascade 0 of the textured scene rendered full at M, full at PM (M
    moved by (5, -3) texels), and scrolled from the PM map to M."""
    jb = build_textured_scene(jproc, jsa, jtex, jmath)
    b = build_textured_scene(proc, sa, tex, tmath)
    jcam, cam = JCamera(width=128, height=64), Camera(width=128, height=64)
    for c in (jcam, cam):
        c.position = np.array([0.5, 2.0, 6.0])
        c.look_at(np.array([0.0, 1.0, -3.0]))
    j_pools = jax_pools(jb, texture_pool=jb.texture_pool)
    j_inst = jb.frame_instances(jcam)
    pools = build_meshlet_pools(b, texture_pool=b.texture_pool, device="cpu")
    inst = b.frame_instances(cam, device="cpu")

    sun = np.array([0.3, 0.8, 0.5]) / np.linalg.norm([0.3, 0.8, 0.5])
    mats = np.asarray(jshadow.fit_cascades_device(
        jnp.asarray(-cam.view_uniform(0).translated_world_to_view[:3, 2],
                    jnp.float32),
        jnp.asarray(sun, jnp.float32), jnp.float32(0.6), jnp.float32(0.4),
        jnp.asarray([0.5, 30.0], jnp.float32),
        jshadow.ShadowConfig(**SCFG))[0])
    prev = mats.copy()
    prev[0, 3, 0] -= 5 * 2.0 / R       # dx = +5 texels
    prev[0, 3, 1] += -3 * 2.0 / R      # dy = -3 texels
    j_rc = JConfig(**CFG, interpret=True).raster_config()
    j_mcfg = JMcfg(**mcfg_fields, shadow_cfg=jshadow.ShadowConfig(**SCFG))
    rc = RendererConfig(**CFG).raster_config()
    mcfg = MeshletFrameConfig(**mcfg_fields,
                              shadow_cfg=shadow.ShadowConfig(**SCFG))

    out = {}
    for name, m, pm in (("full", mats, None), ("prev", prev, None),
                        ("scrolled", mats, "prev")):
        prev_map = None if pm is None else out[pm][1]
        j = _jax_refresh(
            j_pools, j_inst, jnp.asarray(m), jnp.asarray(_planes(m[0])),
            None if pm is None else jnp.asarray(prev_map),
            None if pm is None else jnp.asarray(prev[0]),
            None if pm is None else jnp.float32(1.0), rc=j_rc, mcfg=j_mcfg)
        p = render_shadow_cascade(
            pools, inst, None, rc, mcfg, 0, mats=t_(m),
            planes_all=t_(_planes(m[0])),
            prev_map=None if pm is None else t_(prev_map),
            prev_mat=None if pm is None else t_(prev[0]),
            prev_valid=None if pm is None else t_(1.0))
        out[name] = (p.numpy(), np.asarray(j))
    return out


def _close_maps(got, ref):
    d = np.abs(got - ref)
    assert ((got > 0) == (ref > 0)).mean() >= 0.999
    assert (d <= 2e-4).mean() >= 0.999 and d.max() <= 1e-3, d.max()


@pytest.mark.parametrize("refresh", ["full", "scrolled"])
def test_render_shadow_cascade_matches(cascades, refresh):
    got, ref = cascades[refresh]
    assert got.shape == ref.shape == (R, R)
    assert (ref > 0).mean() > 0.05
    _close_maps(got, ref)


def test_scrolled_refresh_equals_the_full_one(cascades):
    """The scrolled refresh (cached map shifted by the texel translation,
    only the exposed strips rastered) reproduces the full raster at the
    new matrix, in both packages: a wrong shift sign would misplace every
    texel (the PM map itself differs from the M map)."""
    for i in (0, 1):
        scrolled, full = cascades["scrolled"][i], cascades["full"][i]
        assert (np.abs(scrolled - full) <= 1e-6).mean() >= 0.99
        assert (np.abs(cascades["prev"][i] - full) > 1e-6).mean() > 0.05


def test_shadow_raster_on_the_reference_setup(cascades):
    """The depth-only cascade raster (R=256, tile_h=128, no backface cull)
    fed chord_tpu's own cull + mesh-shader setup equals chord_tpu's raster
    to the raster bound (depth 1e-6)."""
    del cascades    # after the module's other chord_tpu compiles
    jb = build_textured_scene(jproc, jsa, jtex, jmath)
    jcam = JCamera(width=128, height=64)
    jcam.position = np.array([0.5, 2.0, 6.0])
    jcam.look_at(np.array([0.0, 1.0, -3.0]))
    j_pools = jax_pools(jb, texture_pool=jb.texture_pool)
    j_inst = jb.frame_instances(jcam)
    cfg = jshadow.ShadowConfig(**SCFG)
    m = np.asarray(jshadow.fit_cascades_device(
        jnp.asarray([0.0, -0.1, -1.0]), jnp.asarray([0.3, 0.8, 0.5]) /
        jnp.linalg.norm(jnp.asarray([0.3, 0.8, 0.5])), jnp.float32(0.6),
        jnp.float32(0.4), jnp.asarray([0.5, 30.0]), cfg)[0])[0]
    res = jcull.cull_pairs(j_pools, j_inst, jnp.asarray(_planes(m)[0]),
                           jnp.float32(0.5 * R * m[1, 1]), 128,
                           lod_threshold=4.0, enable_cone=False,
                           masked=False)
    js = jms.mesh_shader_setup(res.draws, j_pools, j_inst, jnp.asarray(m),
                               128, R, R, backface_cull=False, sub_s=8,
                               interpret=True)
    cfg_r = dict(width=R, height=R, tile_h=128, pair_capacity=1024,
                 big_capacity=64, sub_s=8)
    jrc = jr.RasterConfig(**cfg_r, interpret=True)
    ref = np.asarray(jr.raster_queue(jr.bin_windows(js, jrc), js, jrc)[0])
    t = lambda a: torch.from_numpy(np.array(a))
    setup = raster.TriangleSetup(
        coefT=t(np.asarray(js.coefT)[:, :32].view(np.int32)),
        window_bbox=t(js.window_bbox), window_valid=t(js.window_valid),
        valid=t(js.valid), sub_bounds=t(js.sub_bounds))
    rc = raster.RasterConfig(**cfg_r)
    got = raster.raster_queue(raster.bin_windows(setup, rc), setup, rc)[0]
    assert (ref > 0).mean() > 0.05
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("counts", [(5, 6), (1, 1), (16, 16), (3, 7)])
def test_pcss_params_cache_equals_fresh(counts):
    """K6's wrapper builds its offsets struct once per ShadowConfig: the
    cached struct is the one a fresh build gives, byte for byte, and a
    changed config gets its own."""
    from chord_tpu_torch.ops import shadow_kernel

    cfg = shadow.ShadowConfig(pcss_blocker_samples=counts[0],
                              pcss_pcf_samples=counts[1])
    cached = shadow_kernel._params(cfg)
    assert shadow_kernel._params(cfg) is cached
    assert bytes(cached) == bytes(shadow_kernel._params.__wrapped__(cfg))
    wider = shadow_kernel._params(cfg._replace(pcf_radius_px=3.0))
    assert bytes(wider) != bytes(cached) and wider.pcf_radius == 3.0
    assert (cached.n_blk, cached.n_pcf) == counts

