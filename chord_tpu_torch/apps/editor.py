"""Headless scene editor (port of apps/editor.py): the flower editor's
editing duties as an interactive CLI (reference: application/flower —
Outliner, Detail panel, Content browser and Viewport widgets,
flower/flower.cpp:142-182).

Headless, each widget becomes a command family over the same engine
layers the reference edits through:

  Outliner        -> `ls` / `add` / `rm` / `reparent` / `show` / `hide`
  Detail (RTTR)   -> `inspect` / `set node comp.field value`
                     (dataclass-registry-driven, scene/components.py)
  Content browser -> `assets` (AssetManager scan + header-only meta,
                     incl. thumbnails) / `import` (glTF -> mesh library)
  Viewport        -> `render out.png` (SceneSubsystem.frame_state ->
                     MeshletRenderer, the viewer's path)
  Save prompts    -> dirty tracking + `save`, unsaved-changes guard on
                     `quit` (reference: window-close interception,
                     application.h:186)

Run interactively (`python -m chord_tpu_torch.apps.editor`) or scripted
(`--exec "cmd; cmd; ..."`, the unit-testable mode). It renders on the card
unless given `--device cpu`; without a card and without that flag it
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import shlex
import sys
from pathlib import Path

import numpy as np

from ..scene import Scene, SceneNode, SceneSubsystem
from ..scene.components import _COMPONENT_TYPES, MeshComponent, SkyComponent
from ..utils.log import get_logger
from .viewer import resolve_device

log = get_logger("editor")


def _axis_angle_quat(axis: np.ndarray, deg: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    h = np.deg2rad(deg) * 0.5
    return np.concatenate([axis * np.sin(h), [np.cos(h)]])


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz])


def _parse_value(s: str):
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


class Editor:
    """Command interpreter over a Scene + SceneSubsystem whose pools live
    on `device` (None = the card; raises without one)."""

    def __init__(self, nanite: bool = False, device=None):
        self.device = resolve_device(device)
        self.scene = Scene("untitled")
        self.sub = SceneSubsystem(nanite=nanite, device=self.device)
        self.sub.register_builtin_meshes()
        self.sub.set_scene(self.scene)
        self.path: Path | None = None
        self.last_frame = None        # (H,W,3) u8 — becomes the thumbnail
        self.out = print

    # --- helpers ----------------------------------------------------------
    def _node(self, name: str) -> SceneNode:
        n = self.scene.find(name)
        if n is None:
            raise KeyError(f"no node named '{name}'")
        return n

    # --- commands ---------------------------------------------------------
    def cmd_help(self):
        self.out(__doc__.split("Run interactively")[0])
        names = sorted(m[4:] for m in dir(self) if m.startswith("cmd_"))
        self.out("commands: " + ", ".join(names))

    def cmd_new(self, name: str = "untitled"):
        self.scene = Scene(name)
        self.sub.set_scene(self.scene)
        self.path = None

    def cmd_load(self, path: str):
        self.scene = Scene.load(path)
        self.sub.set_scene(self.scene)
        self.path = Path(path)
        self.out(f"loaded '{self.scene.name}'")

    def cmd_save(self, path: str = ""):
        p = Path(path) if path else self.path
        if p is None:
            raise ValueError("no path: save <file.chtp>")
        self.scene.save(p, thumbnail=self.last_frame)
        self.path = p

    def cmd_ls(self):
        def walk(n: SceneNode, depth: int):
            comps = ", ".join(type(c).__name__.replace("Component", "")
                              for c in n.components)
            vis = "" if n.visible else " [hidden]"
            t = n.transform.translation
            self.out(f"{'  ' * depth}{n.name}{vis} "
                     f"@({t[0]:.6g},{t[1]:.6g},{t[2]:.6g})"
                     + (f" <{comps}>" if comps else ""))
            for c in n.children:
                walk(c, depth + 1)
        walk(self.scene.root, 0)

    def cmd_add(self, parent: str, name: str):
        self._node(parent).add_child(SceneNode(name))
        self.scene.dirty = True

    def cmd_rm(self, name: str):
        n = self._node(name)
        if n.parent is None:
            raise ValueError("cannot remove the root")
        n.parent.children.remove(n)
        self.scene.dirty = True

    def cmd_reparent(self, name: str, new_parent: str):
        n = self._node(name)
        p = self._node(new_parent)
        if n.parent is not None:
            n.parent.children.remove(n)
        p.add_child(n)
        self.scene.dirty = True

    def cmd_show(self, name: str):
        self._node(name).visible = True
        self.scene.dirty = True

    def cmd_hide(self, name: str):
        self._node(name).visible = False
        self.scene.dirty = True

    def cmd_mesh(self, node: str, mesh_key: str, material_key: str = ""):
        if mesh_key not in self.sub.meshes:
            raise KeyError(f"mesh '{mesh_key}' not in library "
                           f"(have: {', '.join(sorted(self.sub.meshes))})")
        self._node(node).add_component(
            MeshComponent(mesh_key=mesh_key,
                          material_key=material_key or "default"))
        self.scene.dirty = True

    def cmd_sky(self, node: str, x: str = "0.3", y: str = "0.8",
                z: str = "0.5"):
        self._node(node).add_component(
            SkyComponent(sun_direction=[float(x), float(y), float(z)]))
        self.scene.dirty = True

    def cmd_move(self, node: str, x: str, y: str, z: str):
        self._node(node).transform.translation = [float(x), float(y),
                                                  float(z)]
        self.scene.dirty = True

    def cmd_rotate(self, node: str, axis: str, deg: str):
        ax = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}[axis.lower()]
        t = self._node(node).transform
        q = _quat_mul(_axis_angle_quat(np.asarray(ax, np.float64),
                                       float(deg)),
                      np.asarray(t.rotation, np.float64))
        t.rotation = (q / np.linalg.norm(q)).tolist()
        self.scene.dirty = True

    def cmd_scale(self, node: str, s: str):
        self._node(node).transform.scale = [float(s)] * 3
        self.scene.dirty = True

    def cmd_mat(self, key: str, r: str, g: str, b: str,
                rough: str = "0.8", metal: str = "0.0"):
        from ..rhi.scene_arrays import MaterialData
        self.sub.register_material(key, MaterialData(
            base_color=(float(r), float(g), float(b), 1.0),
            roughness=float(rough), metallic=float(metal)))

    def cmd_inspect(self, name: str):
        n = self._node(name)
        for c in [n.transform] + n.components:
            self.out(f"  {type(c).__name__}:")
            for f in dataclasses.fields(c):
                if f.name == "node":
                    continue
                self.out(f"    {f.name} = {getattr(c, f.name)}")

    def cmd_set(self, name: str, field_path: str, *values: str):
        """set <node> <Component.field> <value...> — the Detail panel's
        dataclass-registry editing (reference: RTTR-driven detail.cpp)."""
        comp_name, field_name = field_path.split(".", 1)
        n = self._node(name)
        comps = {type(c).__name__: c for c in [n.transform] + n.components}
        short = {k.replace("Component", ""): v for k, v in comps.items()}
        c = comps.get(comp_name) or short.get(comp_name)
        if c is None:
            raise KeyError(f"node has no component '{comp_name}' "
                           f"(have: {', '.join(comps)})")
        if not any(f.name == field_name for f in dataclasses.fields(c)):
            raise KeyError(f"{type(c).__name__} has no field '{field_name}'")
        cur = getattr(c, field_name)
        vals = [_parse_value(v) for v in values]
        setattr(c, field_name, vals if isinstance(cur, (list, tuple))
                else vals[0])
        self.scene.dirty = True

    def cmd_assets(self, root: str = "."):
        """Content browser: scan *.chtp containers, header-only meta."""
        from ..asset.manager import AssetManager
        from ..asset.serialize import load_meta
        am = AssetManager()
        found = list(am.scan(root))
        for a in found:
            kind, meta = load_meta(a.path)
            thumb = "thumb" if "thumbnail" in meta else "     "
            self.out(f"  {a.path}  [{kind}] {thumb} "
                     f"{meta.get('name', '')}")
        if not found:
            self.out("  (no .chtp assets)")

    def cmd_import(self, path: str, prefix: str = ""):
        """glTF -> mesh/material library (content-browser import dialog,
        reference flower/widget/assets/gltf.cpp)."""
        from ..asset.gltf import load_gltf
        doc = load_gltf(path)
        prefix = prefix or Path(path).stem
        n = 0
        for i, mesh in enumerate(doc.meshes):
            self.sub.register_mesh(f"{prefix}.{i}", mesh)
            n += 1
        self.out(f"imported {n} meshes as '{prefix}.*'")

    def cmd_render(self, out_png: str = "editor_view.png",
                   w: str = "192", h: str = "108", px: str = "6",
                   py: str = "4", pz: str = "8"):
        """Viewport: render the scene headlessly through the same
        SceneSubsystem -> MeshletRenderer path as the viewer."""
        from ..renderer import (MeshletFrameConfig, MeshletRenderer,
                                RendererConfig)
        from ..utils.camera import Camera

        W, H = int(w), int(h)
        cam = Camera(width=W, height=H)
        cam.position = np.array([float(px), float(py), float(pz)])
        cam.look_at(np.zeros(3))
        col = self.scene.tick(0.0, n_views=1)[0]
        if not col.instances:
            raise ValueError("nothing to render: add mesh components")
        pools, inst = self.sub.frame_state(col, cam)
        # chord_tpu's two capacity pairs: the small preview pair on the
        # CPU, the larger one on the card
        pc, dc = ((512, 128) if self.device.type == "cpu"
                  else (4096, 1024))
        r = MeshletRenderer(
            RendererConfig(width=W, height=H, pair_capacity=pc,
                           big_capacity=32, enable_bloom=False,
                           enable_tsr=False),
            MeshletFrameConfig(draw_capacity=dc, occlusion=False))
        img, stats = r.render(pools, inst, cam.view_uniform(0))
        arr = img.cpu().numpy().astype(np.uint8)
        self.last_frame = arr
        self.last_stats = stats
        from PIL import Image
        Image.fromarray(arr).save(out_png)
        self.out(f"rendered {W}x{H} -> {out_png} "
                 f"(drawn_tris={int(stats['drawn_tris'])})")

    def cmd_components(self):
        self.out("registered component types (the RTTR registry analog):")
        for k in sorted(_COMPONENT_TYPES):
            self.out(f"  {k}")

    # --- dispatch ----------------------------------------------------------
    def run_line(self, line: str) -> bool:
        """-> False to quit."""
        parts = shlex.split(line.strip())
        if not parts:
            return True
        cmd, args = parts[0], parts[1:]
        if cmd in ("quit", "exit"):
            if self.scene.dirty:
                self.out("unsaved changes — `save <path>` first or "
                         "`quit!` to discard")
                return True
            return False
        if cmd == "quit!":
            return False
        fn = getattr(self, f"cmd_{cmd}", None)
        if fn is None:
            self.out(f"unknown command '{cmd}' (try: help)")
            return True
        try:
            fn(*args)
        except Exception as e:   # noqa: BLE001 — REPL surfaces, not dies
            self.out(f"error: {type(e).__name__}: {e}")
        return True


def run_script(ed: Editor, batch: str) -> None:
    """The --exec mode: `batch`'s semicolon-separated commands in order,
    up to a quit."""
    for line in batch.split(";"):
        if not ed.run_line(line):
            break


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chord_tpu_torch scene editor")
    ap.add_argument("--exec", dest="batch", default="",
                    help="semicolon-separated commands, then exit")
    ap.add_argument("--scene", default="", help="scene asset to open")
    ap.add_argument("--nanite", action="store_true",
                    help="build library meshes through the Nanite DAG")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one). `--device cpu` renders with the kernels' "
                         "plain versions on the CPU")
    args = ap.parse_args(argv)

    ed = Editor(nanite=args.nanite, device=args.device)
    if args.scene:
        ed.cmd_load(args.scene)
    if args.batch:
        run_script(ed, args.batch)
        return 0
    ed.out("chord_tpu_torch editor — `help` for commands")
    while True:
        try:
            line = input("chord> ")
        except (EOFError, KeyboardInterrupt):
            break
        if not ed.run_line(line):
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
