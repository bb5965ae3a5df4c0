"""The port's viewer and editor (chord_tpu_torch/apps) against chord_tpu's
(apps/viewer.py, apps/editor.py) on the CPU.

The same --exec script in both editors gives the same outliner, inspect
and content-browser output and byte-equal saved .chtp scenes (the glTF
import goes through each package's importer into its mesh library). One
viewer frame of assets/demo_street.glb at 96x54 with --device cpu
(textured, with the masked leaf cards; no occlusion, so chord_tpu's
interpret-mode compile stays short) is held to chord_tpu's
MeshletRenderer frame of the scene chord_tpu's viewer builds, with the
frame config its viewer derives, within 2 u8 levels (the port's plain
kernel versions against chord_tpu's Pallas kernels in interpret mode;
frame tests elsewhere give the reasons for the tolerance). The viewer
also renders the saved .chtp through SceneSubsystem, and without a card
both apps raise unless given --device cpu.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from apps import editor as jeditor  # noqa: E402
from apps import viewer as jviewer  # noqa: E402
from chord_tpu.ops.shadow import ShadowConfig as JShadowConfig  # noqa: E402
from chord_tpu.renderer.deferred import RendererConfig as JConfig  # noqa
from chord_tpu.renderer.meshlet_frame import \
    MeshletFrameConfig as JMcfg  # noqa: E402
from chord_tpu.renderer.meshlet_frame import \
    MeshletRenderer as JRenderer  # noqa: E402
from chord_tpu.rhi.meshlet_scene import \
    build_meshlet_pools as jax_pools  # noqa: E402
from chord_tpu.utils.camera import Camera as JCamera  # noqa: E402

from chord_tpu_torch.apps import editor, viewer  # noqa: E402

GLB = REPO / "assets" / "demo_street.glb"
W, H = 96, 54


def _script(save_to):
    return [f"import {GLB} street", "add root block", "mesh block street.0",
            "add block lamp", "mesh lamp street.4", "move lamp 1.5 0 -2",
            "add root crate", "mesh crate builtin.box", "mat red 0.8 0.1 0.1",
            "set crate Mesh.material_key red", "rotate crate y 30",
            "scale block 1.5", "sky root 0.3 0.8 0.5", "hide lamp",
            "show lamp", "rm nope", "reparent crate block", "ls",
            "inspect crate", "components", f"save {save_to}", "quit",
            f"assets {save_to.parent}"]


def _run_editor(ed, script):
    lines = []
    ed.out = lines.append
    for line in script:
        ed.run_line(line)
    return lines


def test_editors_give_the_same_output_and_scene(tmp_path):
    p, jp = tmp_path / "port" / "s.chtp", tmp_path / "ref" / "s.chtp"
    p.parent.mkdir()
    jp.parent.mkdir()
    got = _run_editor(editor.Editor(device="cpu"), _script(p))
    ref = _run_editor(jeditor.Editor(), _script(jp))
    # the content browser prints each file's path: the rest must match
    assert [ln.replace(str(p), "S") for ln in got] == \
        [ln.replace(str(jp), "S") for ln in ref]
    assert any(ln.startswith("imported 6 meshes") for ln in got)
    assert any(ln.startswith("error: KeyError") for ln in got)
    assert p.read_bytes() == jp.read_bytes()
    # each editor loads the other's file and lists the same tree
    a, b = editor.Editor(device="cpu"), jeditor.Editor()
    assert _run_editor(a, [f"load {jp}", "ls"]) == \
        _run_editor(b, [f"load {p}", "ls"])


@pytest.fixture(scope="module")
def glb_frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("view")
    args = viewer.parse_args([
        "--scene", str(GLB), "--device", "cpu", "--width", str(W),
        "--height", str(H), "--draw-capacity", "1024", "--pair-capacity",
        "4096", "--no-occlusion", "--out", str(out)])
    got = viewer.run(args)
    b, pos, target = jviewer.build_scene(str(GLB))
    rcfg, mcfg = viewer.frame_config(args, got["builder"])
    r = JRenderer(JConfig(**rcfg._asdict(), interpret=True), JMcfg(
        **dict(mcfg._asdict(), shadow_cfg=JShadowConfig(
            **mcfg.shadow_cfg._asdict()))))
    cam = JCamera(width=W, height=H)
    cam.position = pos
    cam.look_at(target)
    img, stats = r.render(jax_pools(b, nanite=True,
                                    texture_pool=b.texture_pool),
                          b.frame_instances(cam), cam.view_uniform(0))
    return got, out, (np.asarray(img), stats)


def test_viewer_glb_frame_matches_chord_tpu(glb_frames):
    got, out, (ref, ref_stats) = glb_frames
    img = got["images"][0]
    assert img.shape == ref.shape == (H, W, 3)
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    assert (d <= 2).mean() >= 0.999, (d.max(), (d > 2).mean())
    for k, v in ref_stats.items():
        # drawn_tris counts the triangles K2's setup keeps: chord_tpu
        # keeps one more here, the same setup in float64 keeps the port's
        # count (XLA's FMAs round one edge case the other way), and that
        # triangle wins no pixel: the images are equal
        tol = 1 if k == "drawn_tris" else 0
        assert abs(int(got["stats"][0][k]) - int(np.asarray(v))) <= tol, k
    assert int(got["stats"][0]["draws_masked"]) > 0
    from PIL import Image
    np.testing.assert_array_equal(
        np.asarray(Image.open(out / "frame_0000.png")), img)


def test_viewer_renders_a_saved_scene(tmp_path):
    """A .chtp the editor saved, through the viewer's SceneSubsystem path
    (whose library holds the builtin meshes, as chord_tpu's viewer)."""
    p = tmp_path / "s.chtp"
    _run_editor(editor.Editor(device="cpu"), [
        "add root ground", "mesh ground builtin.plane", "scale ground 8",
        "add root crate", "mesh crate builtin.box", "move crate 0 0.5 0",
        "add crate ball", "mesh ball builtin.sphere", "move ball 1.5 1 0",
        "sky root", f"save {p}"])
    res = viewer.run(viewer.parse_args([
        "--scene", str(p), "--device", "cpu", "--width", str(W),
        "--height", str(H), "--draw-capacity", "1024", "--pair-capacity",
        "4096", "--frames", "2", "--out", str(tmp_path / "v")]))
    assert len(res["images"]) == 2 and res["images"][-1].std() > 5.0
    for st in res["stats"]:
        assert int(st["bin_overflow"]) == 0 and int(st["drawn_tris"]) > 0
    assert (tmp_path / "v" / "frame_0001.png").exists()


def test_apps_need_a_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        viewer.main(["--scene", str(GLB), "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        editor.Editor()
    assert jax.default_backend() == "cpu"
