"""The bench-size ray golden (tests/goldens/bench/all_exact_rays.npz) and
what chip_smoke.py's phase 13 holds to it, checked without tracing it.

`tests/bench_parity.py rays all_exact` records a seeded 4,096 rays of each
rt.trace call of the port's CPU frame 0 of chip_smoke's `all_exact` path,
and for RTAO's and the specular GI's calls what their directions are made
of; `tests/bench_goldens.py all_exact_rays` makes those directions with
chord_tpu's own functions, traces every call through chord_tpu's own
triangle BVH of the bench scene (without FMA) and records the directions,
t, leaf and the BVH arrays' hashes. Here: the file and its manifest entry
agree and stay small, the cell is the path chip_smoke runs, and
chip_smoke.hold_rays passes on the golden's own results (the port's
directions made from the recorded inputs equal to chord_tpu's) and fails
on one direction an ulp off, on one ray's t an ulp off, on one ray's
leaf, on a BVH array that hashes otherwise, and on the dense route.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import bench_goldens as bg
import bench_parity as bp

sys.path.insert(0, bg.REPO)
import chip_smoke  # noqa: E402

from chord_tpu_torch.ops import rt  # noqa: E402
from chord_tpu_torch.ops.gi import GIConfig  # noqa: E402

CELL = "all_exact_rays"


@pytest.fixture(scope="module")
def golden():
    with open(bg.MANIFEST) as f:
        rec = json.load(f)["rays"][CELL]
    path = os.path.join(bg.OUT_DIR, rec["file"])
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    return rec, data, os.path.getsize(path)


def test_ray_golden_is_the_paths_and_matches_its_manifest(golden):
    rec, data, size = golden
    assert size <= 1 << 20
    spec = bg.RAY_CELLS[CELL]
    assert chip_smoke.GOLDEN_RAYS[CELL] == spec["path"] == rec["path"]
    assert chip_smoke.RAY_PATHS[spec["path"]] == spec["granularity"] == \
        rec["granularity"] == "triangle"
    assert chip_smoke.TRACES_PER_FRAME[spec["path"]] == len(rec["calls"])
    assert rec["calls"] == data["calls"].tolist() == [
        "rtao0", "rtao1", "rtao2", "rtao3", "probe", "specular"]
    n = len(rec["calls"])
    assert data["origins"].shape == data["dirs"].shape == (
        n, bp.RAYS_PER_CALL, 3)
    assert data["origins"].dtype == data["dirs"].dtype == np.float32
    assert data["t"].shape == data["leaf"].shape == (n, bp.RAYS_PER_CALL)
    assert data["t"].dtype == np.float32 and data["leaf"].dtype == np.int32
    assert rec["t_max"] == data["t_max"].tolist()
    assert rec["call_rays"] == data["call_rays"].tolist()
    assert rec["seed"] == int(data["seed"]) == bp.RAY_SEED
    assert rec["max_steps"] == 1536 and rec["xla_flags"] == bg.NO_FMA
    assert json.loads(str(data["bvh_sha256"])) == rec["bvh"]
    assert sorted(rec["bvh"]) == sorted(chip_smoke.BVH_ARRAYS)
    assert rec["hit_share"] == [float((lf >= 0).mean())
                                for lf in data["leaf"]]
    # finite rays, misses at t_max, hits inside it
    assert np.isfinite(data["origins"]).all()
    assert np.isfinite(data["dirs"]).all()
    t_max = data["t_max"].astype(np.float32)[:, None]
    miss = data["leaf"] < 0
    assert (data["t"][miss] == np.broadcast_to(t_max, miss.shape)[miss]).all()
    assert (data["t"][~miss] < np.broadcast_to(t_max,
                                               miss.shape)[~miss]).all()
    assert all(0.0 < s < 1.0 for s in rec["hit_share"])
    # the held calls: their directions' inputs at the kept pixels
    held = ["rtao0", "rtao1", "rtao2", "rtao3", "specular"]
    assert rec["held_directions"] == sorted(held)
    assert rec["port_directions_differ"] == {c: 0 for c in held}
    assert rec["frame_count"] == int(data["frame_count"]) == 0
    cfg = chip_smoke.configs(spec["path"])[1].gi_cfg
    assert GIConfig(**rec["gi_cfg"]) == cfg == GIConfig(ao_mode="rtao")
    assert data["pixel"].shape == data["rough"].shape == (
        n, bp.RAYS_PER_CALL)
    assert data["pos"].shape == data["normal"].shape == (
        n, bp.RAYS_PER_CALL, 3)
    assert data["plane"].shape == (n, 2)
    for k, call in enumerate(rec["calls"]):
        h, w = data["plane"][k]
        assert chip_smoke.held_directions(data, k) == (call in held)
        if call in held:
            pix = data["pixel"][k]
            assert (np.diff(pix) > 0).all() and 0 <= pix[0] and \
                pix[-1] < h * w == rec["call_rays"][k]
            # unit normals, zero on sky pixels (no surface)
            length = np.linalg.norm(data["normal"][k], axis=-1)
            assert (np.isclose(length, 1.0, atol=1e-5) | (length == 0)).all()
            assert (length > 0).mean() > 0.5
            assert (data["rough"][k] > 0).any() == (call == "specular")
        else:
            assert (h, w) == (0, 0) and (data["pixel"][k] == -1).all()


def test_bvh_hashes_read_either_packages_arrays():
    sph = np.arange(16, dtype=np.float32).reshape(4, 4)
    bvh = rt.SceneBVH(node_sphere=torch.from_numpy(sph),
                      node_count=torch.ones(4, dtype=torch.int32),
                      node_leaf=torch.arange(4, dtype=torch.int32),
                      leaf_albedo=torch.ones(4, 3),
                      leaf_emissive=torch.zeros(4, 3),
                      leaf_sphere=torch.from_numpy(sph),
                      tri_planes=torch.zeros(4, 12))
    got = chip_smoke.bvh_hashes(bvh)
    same = chip_smoke.bvh_hashes(bvh._replace(**{
        f: getattr(bvh, f).numpy() for f in chip_smoke.BVH_ARRAYS}))
    assert got == same
    assert got["node_sphere"]["shape"] == [4, 4]
    assert got["node_leaf"]["dtype"] == "int32"
    moved = sph.copy()
    moved[0, 0] = np.nextafter(moved[0, 0], np.float32(1))
    assert chip_smoke.bvh_hashes(bvh._replace(
        node_sphere=torch.from_numpy(moved)))["node_sphere"] != \
        got["node_sphere"]


def _fake_trace(data, t_edit=None, leaf_edit=None, dense=False):
    """rt.trace returning the golden's results of the call whose origins
    it is given (optionally edited)."""
    def trace(o, d, bvh, t_max=1e9, max_steps=None):
        k = next(i for i in range(len(data["origins"]))
                 if np.array_equal(o.numpy(), data["origins"][i]))
        t, leaf = data["t"][k].copy(), data["leaf"][k].copy()
        if t_edit is not None and k == t_edit:
            t[7] = np.nextafter(t[7], np.float32(np.inf))
        if leaf_edit is not None and k == leaf_edit:
            leaf[9] = leaf[9] + 1
        if dense:
            trace.dense += 1
        return torch.from_numpy(t), torch.from_numpy(leaf)
    trace.calls = trace.dense = trace.rays = 0
    return trace


def test_phase13_holds_rays_and_fails_on_a_difference(golden, monkeypatch):
    rec, data, _ = golden
    bvh = rt.SceneBVH(*(torch.zeros(1) for _ in range(5)))
    monkeypatch.setattr(chip_smoke, "bvh_hashes", lambda b: rec["bvh"])
    monkeypatch.setattr(rt, "trace", _fake_trace(data))
    out = chip_smoke.hold_rays(CELL, bvh, "cpu")
    assert [out[f"{CELL}_{c}"]["differ"] for c in rec["calls"]] == [0] * 6
    assert [out[f"{CELL}_{c}"]["direction_differ"] for c in rec["calls"]] \
        == [0, 0, 0, 0, None, 0]
    assert out[f"{CELL}_probe"]["hit_share"] == rec["hit_share"][4]

    # the rest on the golden's own directions, one of them an ulp off
    def golden_dirs(name, d, k, cfg, dev, edit=None):
        x = d["dirs"][k].copy()
        if k == edit:
            x[11, 1] = np.nextafter(x[11, 1], np.float32(2))
        return torch.from_numpy(x)
    monkeypatch.setattr(chip_smoke, "ray_directions",
                        lambda *a: golden_dirs(*a, edit=5))
    with pytest.raises(AssertionError, match=r"on calls \['specular'\]"):
        chip_smoke.hold_rays(CELL, bvh, "cpu")
    monkeypatch.setattr(chip_smoke, "ray_directions", golden_dirs)
    for kw, match in ((dict(t_edit=4), "differ from chord_tpu's on calls "
                       r"\['probe'\]"),
                      (dict(leaf_edit=0), r"\['rtao0'\]"),
                      (dict(dense=True), "dense route")):
        monkeypatch.setattr(rt, "trace", _fake_trace(data, **kw))
        with pytest.raises(AssertionError, match=match):
            chip_smoke.hold_rays(CELL, bvh, "cpu")
    monkeypatch.setattr(rt, "trace", _fake_trace(data))
    other = json.loads(json.dumps(rec["bvh"]))
    other["tri_planes"]["sha256"] = "0" * 64
    monkeypatch.setattr(chip_smoke, "bvh_hashes", lambda b: other)
    with pytest.raises(AssertionError, match=r"\['tri_planes'\] differ"):
        chip_smoke.hold_rays(CELL, bvh, "cpu")
