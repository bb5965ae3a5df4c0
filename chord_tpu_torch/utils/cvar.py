"""Console-variable (cvar) registry (port of chord_tpu/utils/cvar.py).

Typed, flagged console variables with change callbacks, settable from code
or ini-style text (reference: source/utils/cvar.h). Every variable
chord_tpu registers is registered with the same name, default, type and
flags: the core renderer variables here, the r.exposure.fix and r.render.*
variables in renderer/deferred.py. Each change bumps `generation`, which a
caller folds into anything it caches per configuration.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from enum import IntFlag
from typing import Any, Callable, Dict, List, Optional


class CVarFlags(IntFlag):
    NONE = 0
    READ_ONLY = 1      # cannot be set after registration
    SCALABILITY = 2    # participates in scalability presets
    ADVANCED = 4


@dataclass
class CVar:
    name: str
    value: Any
    default: Any
    help: str = ""
    flags: CVarFlags = CVarFlags.NONE
    vtype: type = float
    on_change: List[Callable[[Any], None]] = field(default_factory=list)

    def set(self, value: Any) -> None:
        if self.flags & CVarFlags.READ_ONLY:
            raise PermissionError(f"cvar '{self.name}' is read-only")
        value = self.vtype(value)
        if value != self.value:
            self.value = value
            for cb in self.on_change:
                cb(value)

    def reset(self) -> None:
        self.set(self.default)


class CVarSystem:
    """Registry keyed by name (reference: utils/cvar.h CVarSystem)."""

    def __init__(self) -> None:
        self._vars: Dict[str, CVar] = {}
        self._lock = threading.Lock()
        self._generation = 0

    def register(self, name: str, default: Any, help: str = "",
                 flags: CVarFlags = CVarFlags.NONE,
                 vtype: Optional[type] = None) -> CVar:
        with self._lock:
            if name in self._vars:
                return self._vars[name]
            if vtype is None:
                vtype = bool if isinstance(default, bool) else type(default)
            var = CVar(name=name, value=default, default=default, help=help,
                       flags=flags, vtype=vtype)
            var.on_change.append(lambda _v: self._bump())
            self._vars[name] = var
            return var

    def _bump(self) -> None:
        self._generation += 1

    @property
    def generation(self) -> int:
        """Bumped on every change of any variable (an override and its
        restore are two)."""
        return self._generation

    def get(self, name: str) -> Any:
        return self._vars[name].value

    def set(self, name: str, value: Any) -> None:
        self._vars[name].set(value)

    @contextlib.contextmanager
    def override(self, name: str, value: Any):
        """Within the block `name` holds `value`; the old value comes back
        after, whatever happened inside."""
        old = self.get(name)
        self.set(name, value)
        try:
            yield
        finally:
            self.set(name, old)

    def exists(self, name: str) -> bool:
        return name in self._vars

    def all(self) -> Dict[str, CVar]:
        return dict(self._vars)

    def load_text(self, text: str) -> int:
        """Load `name = value` lines (ini-style, '#'/';' comments)."""
        count = 0
        for line in text.splitlines():
            line = line.split("#", 1)[0].split(";", 1)[0].strip()
            if not line or "=" not in line:
                continue
            name, _, raw = line.partition("=")
            name, raw = name.strip(), raw.strip()
            if not self.exists(name):
                continue
            var = self._vars[name]
            if var.vtype is bool:
                var.set(raw.lower() in ("1", "true", "on", "yes"))
            else:
                var.set(var.vtype(raw))
            count += 1
        return count


cvars = CVarSystem()

# chord_tpu's core renderer variables (chord_tpu/utils/cvar.py:125-177),
# the same names, defaults, types and flags; help texts speak of the port
cvars.register("r.raster.tileH", 216, "Raster tile height in pixels.",
               vtype=int)
cvars.register("r.raster.tileW", 128, "Raster tile width in pixels.",
               vtype=int)
cvars.register("r.raster.subS", 8,
               "Raster subwindows per 128-tri window (groups of 128/S "
               "tris, each with its own bbox row loop).", vtype=int)
cvars.register("r.raster.rp", 0,
               "Rows packed per raster row group (0 = auto: subS).",
               vtype=int)
cvars.register("r.raster.subLoop", False,
               "chord_tpu's dynamic subwindow loop (a compile workaround "
               "of its Pallas raster); the CUDA rasters do not read it.",
               vtype=bool)
cvars.register("r.raster.bricks", False,
               "Brick raster (K7, csrc/raster_bricks.cu) in place of K1 on "
               "the main-view rasters; tile_h rounds to a multiple of "
               "4*subS.")
cvars.register("r.raster.binCapacity", 1024,
               "Max binned triangles per tile (overflow counted, logged).",
               vtype=int)
cvars.register("r.raster.bigTriCapacity", 256,
               "Capacity of the large-triangle (tile-spanning) list.",
               vtype=int)
cvars.register("r.texture.compress", True,
               "Block-compress the paged texture pool (BC-style 4x4 blocks, "
               "4x smaller pages decoded per texel fetch — "
               "ops/paged_texture.py compress_page).")
cvars.register("r.instanceculling.enable", True,
               "Object-level frustum culling.")
cvars.register("r.instanceculling.hzb", True,
               "Two-phase HZB occlusion culling.")
cvars.register("r.nanite.errorPixels", 1.0,
               "Cluster-LOD screen-space error threshold in pixels "
               "(reference: nanite_shared.hlsli DAG cut rule).")
cvars.register("r.shadow.cascadeCount", 4, "Number of shadow cascades.",
               vtype=int)
cvars.register("r.gi.enable", False, "Screen-probe GI.")
cvars.register("r.gi.worldcache.probeDim", 32,
               "World radiance cache probe volume dimension.", vtype=int)
cvars.register("r.gi.worldcache.cascades", 8,
               "World radiance cache clipmap cascade count.", vtype=int)
cvars.register("r.tsr.enable", False, "Temporal super resolution.")
cvars.register("r.tsr.sharpeness", 0.5, "TSR sharpen strength.")
cvars.register("r.bloom.enable", True, "Bloom pyramid.")
cvars.register("r.exposure.auto", True, "Histogram auto exposure.")
cvars.register("r.log.file", False, "Also log to disk.")
