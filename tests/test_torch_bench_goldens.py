"""The bench-size goldens (tests/goldens/bench/) and what chip_smoke.py
holds to them, checked without rendering a frame.

tests/bench_goldens.py renders chord_tpu's frames of seven bench.py
commands on the CPU (`off`, BASELINE #3 `nanite`, BASELINE #4 `interior`,
the textured rungs `geo_tex`, `geo_shadow_atmo`, `all` and BASELINE #5
`all_4k`) and of ten of chip_smoke.py's paths (BASELINE #1 `flat`,
`all_ddgi`, `geo_tex_native`, `geo_shadow_atmo_split`,
`off_no_occlusion`, `all_cache`, `geo_tex_bricks`, `all_no_rt` and the
strip frames `sharded_all`, `sharded_flat`) and records them with their
configs, histories and per-frame stats; chip_smoke.py's phase 13 holds
the port's frames on the card to them. Here: the generator's configs,
histories and camera path are chip_smoke's (field for field, leaf shapes
equal, views within f32 rounding; `flat`'s per-frame instance tables and
the instance table `all_ddgi`'s BVH is built from equal; the strip
goldens' strip count, strip config and per-strip history the port's
ShardedRenderer's), the manifest matches its PNGs and the checkout's
chord_tpu sources, chip_smoke's `off` scene is bench.py's build, its
image gates are chord_tpu's, and phase 13 itself passes on the goldens'
own images and fails on a config that is not the manifest's, on a strip
count or on a stat that differs.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

import bench_goldens as bg
from test_golden import ssim, windowed_ssim

sys.path.insert(0, bg.REPO)
import chip_smoke  # noqa: E402

# chip_smoke's path of each cell, and the bench.py size it renders
PATHS = {"off": ("off", 1920, 1080), "nanite": ("off", 1920, 1080),
         "interior": ("all", 1920, 1080), "all_4k": ("all", 3840, 2160),
         "geo_tex": ("geo_tex", 1920, 1080),
         "geo_shadow_atmo": ("geo_shadow_atmo", 1920, 1080),
         "all": ("all", 1920, 1080), "flat": (None, 1920, 1080),
         "all_ddgi": ("all", 1920, 1080),
         "geo_tex_native": ("geo_tex", 1920, 1080),
         "geo_shadow_atmo_split": ("geo_shadow_atmo", 1920, 1080),
         "off_no_occlusion": ("off", 1920, 1080),
         "all_cache": ("all", 1920, 1080),
         "geo_tex_bricks": ("geo_tex", 1920, 1080),
         "all_no_rt": ("all", 1920, 1080),
         "sharded_all": ("all", 1920, 1080),
         "sharded_flat": (None, 1920, 1080)}
SCENE = {"off": "bistro", "nanite": "nanite", "interior": "interior",
         "all_4k": "bistro", "geo_tex": "bistro", "geo_shadow_atmo": "bistro",
         "all": "bistro", "flat": "sponza", "all_ddgi": "bistro",
         "geo_tex_native": "bistro", "geo_shadow_atmo_split": "bistro",
         "off_no_occlusion": "bistro", "all_cache": "bistro",
         "geo_tex_bricks": "bistro", "all_no_rt": "bistro",
         "sharded_all": "bistro", "sharded_flat": "sponza"}
# each cell's render size and pair, big-window and draw capacities
SIZES = {c: (1280, 720, 8192, 64, 2048) for c in bg.CELLS}
SIZES.update(flat=(1920, 1080, 16384, 128, None),
             sharded_flat=(1920, 1080, 16384, 128, None),
             geo_tex_native=(1920, 1080, 8192, 64, 2048),
             sharded_all=(1920, 1080, 8192, 64, 2048),
             all_4k=(2560, 1440, 24576, 128, 4096))
STRIPS = ("sharded_all", "sharded_flat")


def smoke_configs(cell, blend_textured):
    """chip_smoke's configs of a cell's path (a strip path's
    sharded_configs)."""
    return (chip_smoke.sharded_configs if cell in STRIPS
            else chip_smoke.configs)(cell, blend_textured)


_PNGS, _GATES = {}, {}


@pytest.fixture(autouse=True)
def _gates_once(monkeypatch):
    """chip_smoke's PNG reads and image gates, each image pair computed
    once in this module (the phase 13 cases hold the same goldens to
    themselves again and again; a 1080p pair takes ~1 s)."""
    import hashlib

    read, gates = chip_smoke.read_png, chip_smoke.image_gates

    def read_once(path):
        if path not in _PNGS:
            _PNGS[path] = read(path)
        return _PNGS[path].copy()

    def gates_once(img, ref):
        key = tuple(hashlib.sha256(np.ascontiguousarray(x).tobytes())
                    .hexdigest() for x in (img, ref)) + (img.shape,
                                                         ref.shape)
        if key not in _GATES:
            _GATES[key] = gates(img, ref)
        return dict(_GATES[key])

    monkeypatch.setattr(chip_smoke, "read_png", read_once)
    monkeypatch.setattr(chip_smoke, "image_gates", gates_once)


@pytest.fixture(scope="module")
def manifest():
    with open(bg.MANIFEST) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def blend():
    """bench.py's blend_textured of each cell's scene (from its
    materials, as bench.py:215-217 computes it)."""
    from chord_tpu.asset.procedural import (build_bistro_interior,
                                            build_bistro_like,
                                            build_nanite_stress)

    out = {}
    for scene, b in (("bistro", build_bistro_like(**chip_smoke.BISTRO)),
                     ("nanite", build_nanite_stress(rings=16 * bg.DETAIL)),
                     ("interior", build_bistro_interior(detail=bg.DETAIL))):
        out[scene] = any(m.alpha_mode == "blend" and
                         m.base_color_texture >= 0 for m in b.materials)
    out["sponza"] = None      # the flat frame has no blend bucket
    return {cell: out[SCENE[cell]] for cell in PATHS}


@pytest.mark.parametrize("cell", list(PATHS))
def test_generator_configs_are_chip_smokes(cell, blend):
    features, w, h = PATHS[cell]
    jcfg, jmcfg = (bg.cell_configs(cell, blend[cell]) if cell in bg.CELLS
                   else bg.bench_configs(features, w, h, blend[cell]))
    assert jcfg.interpret
    if cell in bg.CELLS and features is not None:
        assert bg.CELLS[cell]["features"] == features
    config, mcfg = smoke_configs(cell, blend[cell])
    for j, t in ((jcfg, config), (jmcfg, mcfg)):
        assert json.loads(json.dumps(chip_smoke.config_dict(t))) == \
            json.loads(json.dumps(chip_smoke.config_dict(j)))


@pytest.mark.parametrize("cell", list(bg.CELLS))
def test_manifest_configs_are_the_generators(cell, manifest, blend):
    rec = manifest["cells"][cell]
    jcfg, jmcfg = bg.cell_configs(cell, blend_textured=blend[cell])
    assert rec["renderer_config"] == json.loads(json.dumps(
        chip_smoke.config_dict(jcfg)))
    assert rec["meshlet_config"] == json.loads(json.dumps(
        chip_smoke.config_dict(jmcfg)))
    assert rec["command"] == bg.CELLS[cell]["command"]
    w, h, pairs, big, draws = SIZES[cell]
    assert (rec["render_width"], rec["render_height"]) == (w, h)
    assert (rec["pair_capacity"], rec["big_capacity"],
            rec["draw_capacity"]) == (pairs, big, draws)


@pytest.mark.parametrize("scene,w,h,shadows", [
    ("bistro", 1280, 720, False), ("nanite", 1280, 720, False),
    ("interior", 1280, 720, True), ("bistro", 2560, 1440, True),
    ("bistro", 1280, 720, True)])
def test_camera_path_is_chip_smokes(scene, w, h, shadows):
    from chord_tpu.ops.shadow import ShadowConfig as JShadowConfig
    from chord_tpu.renderer.deferred import DeviceView as JView

    from chord_tpu_torch.ops.shadow import ShadowConfig

    uniforms = bg.camera_uniforms(scene, w, h)
    views = chip_smoke.camera_views(w, h, "cpu",
                                    ShadowConfig() if shadows else None,
                                    scene=scene)
    assert len(uniforms) == len(views) == bg.PATH_FRAMES == chip_smoke.FRAMES
    for u, v in zip(uniforms, views):
        j = JView.from_uniform(u, shadow_cfg=JShadowConfig() if shadows
                               else None)
        n = 0
        for f in dataclasses.fields(v):
            got = getattr(v, f.name)
            if got is None:
                assert getattr(j, f.name, None) is None, f.name
                continue
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(j, f.name)),
                                       rtol=1e-6, atol=2e-6, err_msg=f.name)
            n += 1
        assert n >= 10 + (3 if shadows else 0)


def _np_fields(obj) -> dict:
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in vars(obj).items() if v is not None}


def _assert_same_fields(port, jax_side, what):
    p, j = _np_fields(port), _np_fields(jax_side)
    assert set(p) == set(j), what
    for k in p:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-6, atol=2e-6,
                                   err_msg=f"{what} {k}")


def test_flat_path_is_chip_smokes():
    """`flat`: the generator's Sponza path (a uniform and an instance
    table rebased to each frame's camera, no jitter) is chip_smoke's
    flat_scene, frame for frame (the scene at detail 1: the tables do not
    depend on it)."""
    from chord_tpu.asset.procedural import build_sponza_like

    uniforms, insts = bg.flat_frames(build_sponza_like(detail=1))
    _, tinsts, tuniforms, blend, bvh = chip_smoke.flat_scene("cpu", detail=1)
    assert blend is None and bvh is None
    assert len(uniforms) == len(tuniforms) == chip_smoke.FRAMES
    for i, (u, tu, inst, tinst) in enumerate(zip(uniforms, tuniforms, insts,
                                                 tinsts)):
        _assert_same_fields(tu, u, f"frame {i} uniform")
        _assert_same_fields(tinst, inst, f"frame {i} instances")
    # the camera moves, so the tables differ from frame to frame
    assert not np.array_equal(_np_fields(insts[0])["object_to_tw"],
                              _np_fields(insts[-1])["object_to_tw"])


def test_ddgi_bvh_instances_are_chip_smokes():
    """`all_ddgi`'s meshlet BVH is built from the frames' own instance
    table, with the camera at the path's last position: the generator's
    camera (moved by camera_uniforms) and chip_smoke's (moved by
    camera_views) rebase the bistro's instances equally."""
    from chord_tpu.asset.procedural import build_bistro_like as jbistro
    from chord_tpu.utils.camera import Camera as JCamera

    from chord_tpu_torch.asset.procedural import build_bistro_like
    from chord_tpu_torch.utils.camera import Camera

    jcam, cam = JCamera(width=1280, height=720), Camera(width=1280,
                                                        height=720)
    bg.camera_uniforms("bistro", 1280, 720, jcam)
    chip_smoke.camera_views(chip_smoke.W, chip_smoke.H, "cpu", cam=cam)
    np.testing.assert_array_equal(cam.position, jcam.position)
    _assert_same_fields(build_bistro_like(detail=1).frame_instances(
        cam, device="cpu"), jbistro(detail=1).frame_instances(jcam),
        "instances")
    cfg = bg.cell_configs("all_ddgi")[1]
    assert (cfg.gi_mode, cfg.rt_granularity) == ("ddgi", "meshlet")
    assert chip_smoke.RAY_PATHS["all_ddgi"] == cfg.rt_granularity


def test_manifest_matches_its_pngs(manifest):
    pngs = sorted(f for f in os.listdir(bg.OUT_DIR) if f.endswith(".png"))
    assert pngs == sorted(f"{c}_f{i:02d}.png" for c, s in bg.CELLS.items()
                          for i in s["keep"])
    assert set(manifest["cells"]) == set(bg.CELLS)
    for cell, spec in bg.CELLS.items():
        rec = manifest["cells"][cell]
        assert rec["frames_rendered"] == spec["frames"]
        assert len(rec["stats"]) == len(rec["seconds"]) == spec["frames"]
        assert sorted(map(int, rec["images"])) == list(spec["keep"])
        size = (spec.get("height", 1080), spec.get("width", 1920))
        assert (rec["height"], rec["width"]) == size
        for i, name in rec["images"].items():
            img = chip_smoke.read_png(os.path.join(bg.OUT_DIR, name))
            assert img.shape == size + (3,) and img.dtype == np.uint8
            assert img.std() > 1.0, name
        for st in rec["stats"]:
            assert st["drawn_tris"] > 0
            assert all(v == 0 for k, v in st.items() if "overflow" in k)


def test_manifest_hash_is_the_trees(manifest):
    assert manifest["chord_tpu_sha256"] == chip_smoke.chord_tpu_hash(bg.REPO)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chip_smoke_gates_are_test_goldens(seed):
    rng = np.random.default_rng(seed)
    h, w = [(96, 160), (100, 173), (64, 64)][seed]
    a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    noise = rng.integers(-6, 7, (h, w, 3))
    b = np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)
    assert chip_smoke.ssim(a, b) == ssim(a, b) < 1.0
    assert chip_smoke.windowed_ssim(a, b) == windowed_ssim(a, b) < 1.0
    ws, y, x = chip_smoke.worst_window(a, b)
    assert ws == windowed_ssim(a, b)
    assert chip_smoke.ssim(a[y:y + 16, x:x + 16],
                           b[y:y + 16, x:x + 16]) == pytest.approx(ws)


@pytest.mark.parametrize("share", [0.0, 0.002, 1.0])
def test_worst_window_is_the_loops(share):
    """chip_smoke's worst_window (all windows at once, then the loop on
    the least ones) gives the loop's value and place to the bit, on a
    golden held to itself (windows tied at 1 up to rounding), with a few
    pixels changed, and with every pixel changed."""
    a = np.asarray(Image.open(os.path.join(bg.OUT_DIR, "all_f07.png")))
    a = a[400:720, 1200:1600]
    rng = np.random.default_rng(7)
    b = a.copy()
    m = rng.random(a.shape[:2]) < share
    b[m] = np.clip(b[m].astype(int) + rng.integers(-2, 3, (m.sum(), 3)),
                   0, 255).astype(np.uint8)
    ws, y, x = chip_smoke.worst_window(a, b)
    assert ws == windowed_ssim(a, b)
    assert chip_smoke.ssim(a[y:y + 16, x:x + 16],
                           b[y:y + 16, x:x + 16]) == pytest.approx(ws)


def test_off_scene_is_bench_pys_build(monkeypatch):
    """chip_smoke's `off` (and so `off_no_occlusion`, `geo_tex`) builds
    the bistro with bench.py's own arguments: textures=True for every rung
    (bench.py:88-90)."""
    import chord_tpu.asset.procedural as jproc

    import chord_tpu_torch.asset.procedural as proc

    class Built(Exception):
        pass

    def record(**kwargs):
        raise Built(kwargs)

    real_exists = os.path.exists
    monkeypatch.setattr(os.path, "exists", lambda p: False if str(
        p).startswith("/tmp/chord_scene") else real_exists(p))
    monkeypatch.setattr(jproc, "build_bistro_like", record)
    monkeypatch.setattr(proc, "build_bistro_like", record)
    with pytest.raises(Built) as bench_args:
        bg._bench()._make_scene("bistro", bg.DETAIL, bg.TARGET_TRIS)
    with pytest.raises(Built) as smoke_args:
        chip_smoke.bench_scenes("cpu", ["off"])
    assert smoke_args.value.args[0] == bench_args.value.args[0] == dict(
        detail=3, target_tris=2_600_000, textures=True)
    for p in ("geo_tex", "off_no_occlusion"):
        assert chip_smoke.scene_paths([p])[0] == "off"


def _kept(manifest):
    """The goldens' own images and stats, as phase 5 would keep them."""
    kept = {}
    for cell in chip_smoke.GOLDEN_FRAMES:
        rec = manifest["cells"][cell]
        kept[cell] = dict(
            images={int(i): chip_smoke.read_png(os.path.join(bg.OUT_DIR, n))
                    for i, n in rec["images"].items()},
            stats={k: [st[k] for st in rec["stats"]]
                   for k in rec["stats"][0]})
    return kept


def test_phase13_passes_on_the_goldens_and_fails_on_a_difference(
        manifest, blend):
    kept = _kept(manifest)
    assert set(chip_smoke.GOLDEN_FRAMES) == set(bg.CELLS)
    out = chip_smoke.bench_goldens(kept, blend, "cpu")
    for cell in chip_smoke.GOLDEN_FRAMES:
        assert chip_smoke.GOLDEN_FRAMES[cell] == bg.CELLS[cell]["keep"]
        for i in chip_smoke.GOLDEN_FRAMES[cell]:
            g = out[f"{cell}_f{i:02d}"]
            assert g["ssim"] == pytest.approx(1.0) and g["mae"] == 0.0
        assert out[f"{cell}_stats_differ"] == {}
    with pytest.raises(AssertionError, match="meshlet_config"):
        chip_smoke.bench_goldens(kept, dict(blend, off=not blend["off"]),
                                 "cpu")
    stats = kept["nanite"]["stats"]
    stats["drawn_tris"] = stats["drawn_tris"][:3] + [
        stats["drawn_tris"][3] + 1] + stats["drawn_tris"][4:]
    with pytest.raises(AssertionError, match="stats differ"):
        chip_smoke.bench_goldens(kept, blend, "cpu")


NEW_CELLS = ("flat", "all_ddgi", "geo_tex_native", "geo_shadow_atmo_split",
             "off_no_occlusion", "all_4k", "all_cache", "geo_tex_bricks",
             "all_no_rt", "sharded_all", "sharded_flat")


@pytest.mark.parametrize("cell", NEW_CELLS)
def test_phase13_fails_on_a_new_cells_config_or_stat(cell, manifest, blend,
                                                     monkeypatch):
    """Phase 13 on one of the cells this slice added (alone): it passes on
    the goldens' own frames, and fails on a config other than the
    manifest's (flat: the class default pair capacity; the others:
    the blend bucket's textures flipped) and on one stat of one frame."""
    monkeypatch.setattr(chip_smoke, "GOLDEN_FRAMES",
                        {cell: chip_smoke.GOLDEN_FRAMES[cell]})
    kept = _kept(manifest)
    out = chip_smoke.bench_goldens(kept, blend, "cpu")
    assert out[f"{cell}_stats_differ"] == {}
    with monkeypatch.context() as m:
        if cell in ("flat", "sharded_flat"):
            m.setattr(chip_smoke, "FLAT_PAIRS", 8192)
            want = "renderer_config"
            other = blend
        else:
            want, other = "meshlet_config", dict(blend, **{cell: not blend[
                cell]})
        with pytest.raises(AssertionError, match=want):
            chip_smoke.bench_goldens(kept, other, "cpu")
    stats = kept[cell]["stats"]
    key = "drawn_tris"
    last = len(stats[key]) - 1
    stats[key] = stats[key][:last] + [stats[key][last] - 1]
    with pytest.raises(AssertionError, match="stats differ"):
        chip_smoke.bench_goldens(kept, blend, "cpu")


def test_phase13_fails_on_a_strip_count_the_goldens_do_not_have(
        manifest, blend, monkeypatch):
    """A strip golden is held only to frames of as many strips as it was
    rendered in: four ranks fail on the strip count."""
    monkeypatch.setattr(chip_smoke, "GOLDEN_FRAMES",
                        {"sharded_all": chip_smoke.GOLDEN_FRAMES[
                            "sharded_all"]})
    kept = _kept(manifest)
    chip_smoke.bench_goldens(kept, blend, "cpu")
    monkeypatch.setattr(chip_smoke, "STRIP_RANKS", 4)
    with pytest.raises(AssertionError, match="strips"):
        chip_smoke.bench_goldens(kept, blend, "cpu")


def _shapes(hist) -> dict:
    return {k: list(v.shape) for k, v in
            sorted(chip_smoke.history_leaves(hist).items())}


@pytest.mark.parametrize("cell", [c for c in bg.CELLS if c not in STRIPS])
def test_golden_history_is_chip_smokes(cell, manifest, blend):
    """Each one-card golden's fresh history (bench_goldens.cell_history,
    as chord_tpu's MeshletRenderer builds it: screen probes in probe mode
    only) has the leaf shapes of chip_smoke.history for the path, and of
    the history the golden was rendered with where the manifest records
    it."""
    jcfg, jmcfg = bg.cell_configs(cell, blend[cell])
    config, mcfg = chip_smoke.configs(cell, blend[cell])
    want = _shapes(chip_smoke.history(config, mcfg, "cpu"))
    assert bg.history_shapes(bg.cell_history(cell, jcfg, jmcfg)) == want
    if "history" in manifest["cells"][cell]:
        assert manifest["cells"][cell]["history"] == want
    if cell == "all_cache":     # no screen probes in cache mode
        assert want["probe_sh"][:2] == want["probe_depth"] == [1, 1]


@pytest.mark.parametrize("cell", STRIPS)
def test_strip_goldens_are_the_ports_strips(cell, manifest, blend,
                                            monkeypatch):
    """The strip goldens were rendered in chip_smoke's strip count, with
    the strip config and the per-strip history shapes of the port's
    ShardedRenderer on sharded_configs' config (a rank of STRIP_RANKS)."""
    import chord_tpu_torch.parallel.sharded as sharded

    rec = manifest["cells"][cell]
    n = chip_smoke.STRIP_RANKS
    assert rec["strips"] == bg.CELLS[cell]["strips"] == n
    assert f"--xla_force_host_platform_device_count={n}" in rec["xla_flags"]
    config, mcfg = chip_smoke.sharded_configs(cell, blend[cell])
    monkeypatch.setattr(sharded.dist, "get_world_size", lambda g=None: n)
    monkeypatch.setattr(sharded.dist, "get_rank", lambda g=None: 0)
    monkeypatch.setattr(sharded, "reduces_on_host", lambda g: True)
    r = sharded.ShardedRenderer(config, group=object(),
                                path="flat" if mcfg is None else "meshlet",
                                mcfg=mcfg, device="cpu")
    assert rec["strip_config"] == json.loads(json.dumps(
        chip_smoke.config_dict(r.strip_config)))
    assert r.strip_config.height * n == config.height
    assert rec["history"] == _shapes(r._empty_history())
