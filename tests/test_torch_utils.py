"""The port's host utilities against chord_tpu's: the cvar registry
(every variable, its generation counter, RendererConfig.from_cvars), the
slot allocator, and the name table with its stable hashes (which key
files on disk, so they must equal chord_tpu's bit for bit). The cases of
chord_tpu's tests/test_utils.py for these, run on the port, then the
parity checks."""

import numpy as np
import pytest

import chord_tpu.renderer.deferred as jdeferred
from chord_tpu.utils import names as jnames
from chord_tpu.utils.cvar import cvars as jcvars

import chord_tpu_torch.renderer.deferred as tdeferred
from chord_tpu_torch.utils import names
from chord_tpu_torch.utils.allocator import SlotAllocator
from chord_tpu_torch.utils.cvar import CVarFlags, CVarSystem, cvars


def test_cvar_system():
    cv = CVarSystem()
    cv.register("t.x", 1.5, "test")
    cv.register("t.flag", True, "bool var")
    cv.register("t.ro", 3, flags=CVarFlags.READ_ONLY, vtype=int)
    g0 = cv.generation
    cv.set("t.x", 2.5)
    assert cv.get("t.x") == 2.5
    assert cv.generation > g0
    with pytest.raises(PermissionError):
        cv.set("t.ro", 4)
    n = cv.load_text("t.x = 7.0\nt.flag = off\n# comment\nunknown = 3\n")
    assert n == 2
    assert cv.get("t.x") == 7.0 and cv.get("t.flag") is False


def test_cvar_generation_counts_changes():
    """One bump per change, none for a set to the same value; an override
    and its restore are two changes."""
    cv = CVarSystem()
    cv.register("t.n", 1, vtype=int)
    g0 = cv.generation
    cv.set("t.n", 1)
    assert cv.generation == g0
    cv.set("t.n", 2)
    assert cv.generation == g0 + 1
    with cv.override("t.n", 5):
        assert cv.generation == g0 + 2
    assert cv.get("t.n") == 2 and cv.generation == g0 + 3


def test_renderer_config_from_cvars():
    old_w = cvars.get("r.render.width")
    old_bloom = cvars.get("r.bloom.enable")
    try:
        cvars.set("r.render.width", 640)
        cvars.set("r.bloom.enable", False)
        c = tdeferred.RendererConfig.from_cvars(height=360)
        assert c.width == 640 and c.height == 360
        assert c.enable_bloom is False
        c2 = tdeferred.RendererConfig.from_cvars(width=320)
        assert c2.width == 320
    finally:
        cvars.set("r.render.width", old_w)
        cvars.set("r.bloom.enable", old_bloom)


def test_slot_allocator_recycles_last_freed_first():
    a = SlotAllocator()
    s = [a.allocate() for _ in range(4)]
    assert s == [0, 1, 2, 3] and a.high_water == 4
    a.free(1)
    a.free(3)
    assert a.allocate() == 3
    assert a.allocate() == 1
    assert a.allocate() == 4
    assert a.high_water == 5


def test_string_table_interns_dense_ids():
    t = names.StringTable()
    a = t.intern("wall")
    b = t.intern("floor")
    assert a != b
    assert t.intern("wall") == a
    assert t.lookup(a) == "wall"
    assert len(t) == 2


def test_name_equality_case_insensitive_display_preserved():
    a = names.Name("BaseColor")
    b = names.Name("basecolor")
    assert a == b
    assert hash(a) == hash(b)
    assert a == "BASECOLOR"
    assert str(a) == "BaseColor"
    assert str(b) == "BaseColor"
    assert names.Name(a) == a
    assert names.Name("other") != a
    assert names.lookup(names.intern("RawKey")) == "RawKey"


def test_stable_hash_is_process_stable():
    assert names.stable_hash64("chord") == names.stable_hash64(b"chord")
    assert names.stable_hash64("chord") != names.stable_hash64("chord",
                                                                seed=1)
    assert names.crc32("chord") == names.crc32(b"chord")
    h1 = names.combine_hash(1, 2, 3)
    assert names.combine_hash(1, 2, 3) == h1
    assert names.combine_hash(3, 2, 1) != h1


def _strings(n=64, seed=7):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                    "0123456789._/-é€")
    return ["".join(rng.choice(alphabet, size=int(rng.integers(0, 40))))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_stable_hash64_equals_chord_tpu(seed):
    for s in _strings():
        assert names.stable_hash64(s, seed=seed) == \
            jnames.stable_hash64(s, seed=seed), s


def test_crc32_and_combine_hash_equal_chord_tpu():
    rng = np.random.default_rng(3)
    for s in _strings():
        assert names.crc32(s) == jnames.crc32(s), s
        parts = [int(x) for x in rng.integers(0, 2 ** 63, size=4,
                                              dtype=np.int64)]
        parts.append(names.stable_hash64(s))
        assert names.combine_hash(*parts) == jnames.combine_hash(*parts)


def test_cvar_registry_equals_chord_tpu():
    """Every variable chord_tpu registers (its utils/cvar.py and renderer/
    deferred.py, both imported above), with the same default, type and
    flags, and none more."""
    mine, ref = cvars.all(), jcvars.all()
    assert sorted(mine) == sorted(ref)
    for name, v in ref.items():
        m = mine[name]
        assert (m.default, m.vtype, int(m.flags)) == \
            (v.default, v.vtype, int(v.flags)), name
        assert type(m.default) is type(v.default), name


@pytest.mark.parametrize("overrides", [
    {}, dict(height=360), dict(width=320, output="hdr10"),
    dict(enable_tsr=True, tsr_mode="tile", subtiles=True)])
def test_from_cvars_equals_chord_tpu(overrides):
    """The same fields under the same cvar values and overrides (chord_tpu
    has one more field, `interpret`, which the port drops)."""
    sets = {"r.render.width": 800, "r.render.height": 448,
            "r.render.pairCapacity": 4096, "r.bloom.enable": False,
            "r.tsr.enable": True, "r.render.output": "srgb8"}
    old = {k: cvars.get(k) for k in sets}
    old_j = {k: jcvars.get(k) for k in sets}
    try:
        for k, v in sets.items():
            cvars.set(k, v)
            jcvars.set(k, v)
        mine = tdeferred.RendererConfig.from_cvars(**overrides)._asdict()
        ref = jdeferred.RendererConfig.from_cvars(**overrides)._asdict()
        assert ref.pop("interpret") is False
        assert mine == ref
    finally:
        for k, v in old.items():
            cvars.set(k, v)
        for k, v in old_j.items():
            jcvars.set(k, v)
