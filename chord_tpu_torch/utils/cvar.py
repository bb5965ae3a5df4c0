"""Console-variable (cvar) registry (port of chord_tpu/utils/cvar.py).

Typed, flagged console variables with change callbacks, settable from code
or ini-style text (reference: source/utils/cvar.h). Only the variables the
ported frame reads are registered here: the raster tiling knobs, the
fixed-exposure override and the texture-pool compression switch.
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
            self._vars[name] = var
            return var

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

# The raster knobs read by RendererConfig.raster_config, with chord_tpu's
# registered defaults (chord_tpu/utils/cvar.py:130-150).
cvars.register("r.raster.tileH", 216, "Raster tile height in pixels.",
               vtype=int)
cvars.register("r.raster.subS", 8,
               "Raster subwindows per 128-tri window (groups of 128/S "
               "tris, each with its own bbox row loop).", vtype=int)
cvars.register("r.raster.rp", 0,
               "Rows packed per raster row group (0 = auto: subS).",
               vtype=int)
cvars.register("r.raster.bricks", False,
               "chord_tpu brick accumulator layout; not ported (must stay "
               "False).")
cvars.register("r.exposure.fix", -1.0,
               "fixed exposure; <=0 enables auto exposure")
cvars.register("r.texture.compress", True,
               "Block-compress the paged texture pool (BC-style 4x4 blocks, "
               "4x smaller pages decoded per texel fetch — "
               "ops/paged_texture.py compress_page; chord_tpu's default, "
               "chord_tpu/utils/cvar.py:155).")
