"""The port's scene graph, .chtp container, SceneSubsystem, asset manager
and host utilities against chord_tpu.

The same scene built through either package's API serialises to the same
dict and to byte-equal .chtp files (zlib at the same level over the same
JSON and array pack; the thumbnail through PIL in both), and a file
written by either package loads in the other. SceneSubsystem.frame_state
over two frames with a moving instance gives the pools and instance tables
(prev_matrices, the rigid-delta motion input, included) of chord_tpu's,
exactly: both are the same numpy host code. The AssetManager, events, log
taps and timers behave as tests/test_asset_manager.py and
tests/test_utils.py assert for chord_tpu, on files either package wrote.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import chord_tpu.asset.manager as jmanager
import chord_tpu.asset.serialize as jser
import chord_tpu.scene as jscene
import chord_tpu.scene.components as jcomp
from chord_tpu.rhi.scene_arrays import MaterialData as JMaterialData
from chord_tpu.utils.camera import Camera as JCamera

import chord_tpu_torch.asset.manager as manager
import chord_tpu_torch.asset.serialize as ser
import chord_tpu_torch.scene as scene
import chord_tpu_torch.scene.components as comp
from chord_tpu_torch.rhi.meshlet_scene import MeshletScenePools
from chord_tpu_torch.rhi.scene_arrays import FrameInstances, MaterialData
from chord_tpu_torch.utils.camera import Camera

PACKAGES = {"port": (scene, comp), "chord_tpu": (jscene, jcomp)}


def _build(pkg, name="lobby"):
    """One scene through a package's API: a hierarchy with transforms,
    mesh components (library keys), a sky and a hidden branch."""
    sc, cp = PACKAGES[pkg]
    s = sc.Scene(name)
    root = s.root
    root.add_component(cp.SkyComponent(sun_direction=[0.2, 0.9, 0.1]))
    root.add_component(cp.PostProcessConfig(bloom=False))
    floor = root.add_child(sc.SceneNode("floor"))
    floor.transform.scale = [8.0, 1.0, 8.0]
    floor.add_component(cp.MeshComponent(mesh_key="builtin.plane",
                                         material_key="stone"))
    crate = root.add_child(sc.SceneNode("crate"))
    crate.transform.translation = [1.5, 0.5, -2.0]
    crate.transform.rotation = [0.0, 0.38268343, 0.0, 0.92387953]
    crate.add_component(cp.MeshComponent(mesh_key="builtin.box",
                                         material_key="wood"))
    ball = crate.add_child(sc.SceneNode("ball"))
    ball.transform.translation = [0.0, 1.25, 0.0]
    ball.add_component(cp.MeshComponent(mesh_key="builtin.sphere"))
    hidden = root.add_child(sc.SceneNode("hidden"))
    hidden.visible = False
    hidden.add_component(cp.MeshComponent(mesh_key="builtin.cylinder"))
    hidden.add_component(cp.ShadowConfigComponent(cascade_count=2))
    return s


def test_same_scene_same_dict():
    assert _build("port").to_dict() == _build("chord_tpu").to_dict()
    got = _build("port").tick(1 / 60, n_views=2)
    ref = _build("chord_tpu").tick(1 / 60, n_views=2)
    for c, jc in zip(got, ref):
        assert [(m, t) for m, t, _ in c.instances] == \
            [(m, t) for m, t, _ in jc.instances]
        for (_, _, w), (_, _, jw) in zip(c.instances, jc.instances):
            np.testing.assert_array_equal(w, jw)
        assert c.sky.to_dict() == jc.sky.to_dict()


def test_chtp_cross_loads_and_equal_scenes_write_equal_bytes(tmp_path):
    thumb = np.random.default_rng(0).integers(0, 256, (90, 160, 3),
                                              dtype=np.uint8)
    for t in (None, thumb):
        p, jp = tmp_path / "port.chtp", tmp_path / "ref.chtp"
        _build("port").save(p, thumbnail=t)
        _build("chord_tpu").save(jp, thumbnail=t)
        assert p.read_bytes() == jp.read_bytes()
        # each package loads the other's file
        assert scene.Scene.load(jp).to_dict() == _build("port").to_dict()
        assert jscene.Scene.load(p).to_dict() == _build("chord_tpu").to_dict()
        assert ser.load_meta(jp) == jser.load_meta(p)
    np.testing.assert_array_equal(
        ser.decode_thumbnail(ser.load_meta(jp)[1]),
        jser.decode_thumbnail(jser.load_meta(p)[1]))


def test_container_arrays_round_trip_across_packages(tmp_path):
    payload = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
               "b": [np.array([1, 2], np.uint16), {"c": np.int64(7)}],
               "s": "text"}
    p, jp = tmp_path / "p.chtp", tmp_path / "j.chtp"
    ser.save_asset(p, "raw", payload, meta={"name": "x"})
    jser.save_asset(jp, "raw", payload, meta={"name": "x"})
    assert p.read_bytes() == jp.read_bytes()
    kind, got = ser.load_asset(jp)
    assert kind == "raw" and got["s"] == "text" and got["b"][1]["c"] == 7
    np.testing.assert_array_equal(got["a"], payload["a"])
    assert got["b"][0].dtype == np.uint16
    # a flipped payload byte fails the CRC in either package
    bad = bytearray(p.read_bytes())
    bad[-1] ^= 0xFF
    p.write_bytes(bytes(bad))
    for load in (ser.load_asset, jser.load_asset):
        with pytest.raises(Exception):
            load(p)


def _subsystem(pkg):
    sc, _ = PACKAGES[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    sub = sc.SceneSubsystem(nanite=False, **kw)
    sub.register_builtin_meshes()
    mat = MaterialData if pkg == "port" else JMaterialData
    sub.register_material("stone", mat(base_color=(0.5, 0.5, 0.5, 1.0)))
    sub.register_material("wood", mat(base_color=(0.4, 0.25, 0.1, 1.0),
                                      roughness=0.6))
    sub.set_scene(_build(pkg))
    return sub


def _frames(pkg):
    """Two frames with the crate moving, then a third after a node is
    added -> [(pools, instances)] and the subsystem."""
    sub = _subsystem(pkg)
    cam = (Camera if pkg == "port" else JCamera)(width=64, height=32)
    cam.position = np.array([6.0, 4.0, 8.0])
    cam.look_at(np.zeros(3))
    out = []
    for i in range(3):
        if i == 1:
            sub.scene.find("crate").transform.translation = [2.0, 0.5, -2.5]
        if i == 2:
            sc, cp = PACKAGES[pkg]
            n = sub.scene.root.add_child(sc.SceneNode("extra"))
            n.add_component(cp.MeshComponent(mesh_key="builtin.box"))
        out.append(sub.frame_state(sub.scene.tick(1 / 60)[0], cam))
    return out


def _np(x):
    return {k: np.asarray(v) for k, v in vars(x).items() if v is not None}


def test_subsystem_frame_state_matches():
    got, ref = _frames("port"), _frames("chord_tpu")
    for (pools, inst), (jpools, jinst) in zip(got, ref):
        jp, ji = _np(jpools), _np(jinst)
        for f in dataclasses.fields(MeshletScenePools):
            a = getattr(pools, f.name)
            if isinstance(a, torch.Tensor):
                b = jp[f.name]
                b = b.view(np.int32) if b.dtype == np.uint32 else b
                np.testing.assert_array_equal(a.numpy(), b, f.name)
        for f in dataclasses.fields(FrameInstances):
            a = getattr(inst, f.name)
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(a.numpy(), ji[f.name], f.name)
    # the pair table is kept while the instance set stays, rebuilt when
    # it changes; the moving crate's previous matrix is last frame's
    assert got[1][0] is got[0][0] and got[2][0] is not got[1][0]
    assert not torch.equal(got[1][1].object_to_tw,
                           got[1][1].object_prev_to_tw)
    assert torch.equal(got[0][1].object_to_tw, got[0][1].object_prev_to_tw)


# --- asset manager (tests/test_asset_manager.py on the port) ----------------

def test_manager_meta_lazy_payload_and_kind(tmp_path):
    p = tmp_path / "a.chtp"
    jser.save_asset(p, "raw", {"x": np.arange(6, dtype=np.float32)},
                    meta={"name": "wall", "tag": 7})
    mgr = manager.AssetManager()
    a = mgr.get(p)
    assert a.meta["tag"] == 7 and a.name == "wall"
    assert not a.loaded and not a.dirty
    np.testing.assert_array_equal(a.payload["x"],
                                  np.arange(6, dtype=np.float32))
    assert a.loaded and mgr.get(p) is a
    a.kind = "scene"
    a.unload()
    with pytest.raises(AssertionError):
        _ = a.payload


def test_manager_dirty_save_unload_and_events(tmp_path):
    p = tmp_path / "a.chtp"
    ser.save_asset(p, "raw", {"x": np.arange(3, dtype=np.float32)})
    mgr = manager.AssetManager()
    events = []
    mgr.on_changed.add(events.append)
    a = mgr.get(p)
    _ = a.payload
    mgr.unload_clean_payloads()
    assert not a.loaded
    a.set_payload({"x": np.ones(3, np.float32)})
    mgr.mark_dirty(a)
    mgr.unload_clean_payloads()
    assert a.loaded and mgr.dirty_assets() == [a]
    assert mgr.save_dirty() == 1 and not a.dirty
    assert events == [a, a]
    # chord_tpu's manager reads what the port's saved
    np.testing.assert_array_equal(
        jmanager.AssetManager().get(p).payload["x"], np.ones(3, np.float32))
    new = manager.Asset(payload={"y": np.arange(2, dtype=np.int32)})
    mgr.insert(new, tmp_path / "new.chtp")
    assert new.dirty and mgr.save_dirty() == 1
    assert len(list(manager.AssetManager().scan(tmp_path))) == 2


def test_manager_kind_registry_and_scene_asset(tmp_path):
    @manager.register_kind("blob7")
    class Blob7(manager.Asset):
        def decode(self, payload):
            return payload["x"] * 7

    p = tmp_path / "b.chtp"
    jser.save_asset(p, "blob7", {"x": np.ones(2, np.float32)})
    a = manager.AssetManager().get(p)
    assert isinstance(a, Blob7)
    np.testing.assert_array_equal(a.payload, np.full(2, 7, np.float32))
    _build("chord_tpu").save(tmp_path / "lobby.chtp")
    s = manager.AssetManager().get(tmp_path / "lobby.chtp")
    assert isinstance(s, manager.SceneAsset)
    assert s.to_scene().to_dict() == _build("port").to_dict()


# --- utils (tests/test_utils.py on the port) ---------------------------------

def test_delegates_events_and_lru():
    from chord_tpu_torch.utils.events import (Delegate, Event, LRUCache,
                                              MultiDelegate)

    d = Delegate()
    assert d() is None and not d.bound
    d.bind(lambda x: x * 2)
    assert d(21) == 42
    md = MultiDelegate()
    md.add(lambda x: x + 1)
    md.add(lambda x: x + 2)
    assert md.broadcast(10) == [11, 12]
    assert md.fold(lambda a, b: a + b, 0, 10) == 23
    ev, calls = Event(), []
    ev.add(lambda: calls.append(1) or False)
    ev.add(lambda: calls.append(2) or True)
    ev.add(lambda: calls.append(3) or True)
    assert ev.broadcast_until_handled() is True and calls == [1, 2]
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert "b" not in c and "a" in c and "c" in c
    assert c.get("b") is None and c.hits == 1 and c.misses == 1


def test_log_taps_and_file_log(tmp_path):
    from chord_tpu_torch.utils.log import (enable_file_log, get_logger,
                                           pop_tap, push_tap)

    seen = []
    push_tap(seen.append)
    log = get_logger("test.taps")
    log.info("hello-tap-%d", 42)
    pop_tap(seen.append)
    log.info("after-pop")
    assert any("hello-tap-42" in m for m in seen)
    assert not any("after-pop" in m for m in seen)
    f = tmp_path / "chord.log"
    enable_file_log(str(f))
    log.info("to-the-file")
    assert "to-the-file" in f.read_text()
    assert log.name == "chord_tpu_torch.test.taps"


def test_frame_and_pass_timers():
    from chord_tpu_torch.utils.timer import FrameTimer, PassTimers, time_jitted

    ft = FrameTimer()
    ft.tick()
    time.sleep(0.01)
    dt = ft.tick()
    assert 0.005 < dt < 0.5 and ft.frame_index == 2 and ft.fps > 0
    pt = PassTimers()
    x = torch.ones(8, 8)
    with pt.measure("square", x):
        y = x * x
    with pt.scope("inside-a-span"):
        _ = y + 1
    assert "square" in pt.ms and pt.ms["square"] >= 0.0
    assert "square" in pt.table()
    r = time_jitted(lambda a: a * 2, x, warmup=1, iters=3)
    assert r["min_ms"] <= r["mean_ms"] <= r["max_ms"]
