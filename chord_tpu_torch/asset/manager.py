"""Typed asset registry with lazy payloads and dirty tracking (port of
chord_tpu/asset/manager.py).

The port of the reference's IAsset/AssetManager
(reference: source/asset/asset.h:27 `IAsset` — meta always loaded, bin
lazy, dirty flag + save prompts, snapshot thumbnails; :141
`AssetManager` — RTTR type-registered asset map keyed by path). The
role transfers directly: the GPU-upload half of the reference's asset
flow (AsyncUploader, bindless registration) is absorbed by
the pools' upload to the device at scene build, so this layer is pure host-side
bookkeeping over the versioned container in `serialize.py`.

Design mapping:
- RTTR type registration        -> `register_kind` decorator/classmap
- IAsset::meta (always loaded)  -> `Asset.meta` via header-only
  `load_meta` (no payload decompress)
- lazy bin load                 -> `Asset.payload` property triggers
  the full `load_asset` on first touch
- dirty tracking + saveActions  -> `mark_dirty`/`dirty_assets`/
  `save_dirty` (the flower editor's unsaved-asset prompt feed)
- snapshot thumbnails           -> `Asset.thumbnail` decodes the meta's
  base64 PNG (serialize.decode_thumbnail)
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Type

from .serialize import (decode_thumbnail, load_asset, load_meta,
                        save_asset)

# kind string -> Asset subclass (the RTTR registry analog)
_KIND_REGISTRY: Dict[str, Type["Asset"]] = {}


def register_kind(kind: str) -> Callable[[Type["Asset"]], Type["Asset"]]:
    """Class decorator: register an Asset subclass for a container kind
    (reference asset.h REGISTER_BODY_DECLARE / rttr registration)."""
    def deco(cls: Type["Asset"]) -> Type["Asset"]:
        cls.kind = kind
        _KIND_REGISTRY[kind] = cls
        return cls
    return deco


class Asset:
    """One on-disk asset: always-loaded meta, lazily-loaded payload.

    Subclasses may override `decode(payload)` / `encode()` to give the
    raw container payload a typed face."""

    kind: str = "raw"

    def __init__(self, path: Optional[Path] = None,
                 meta: Optional[Dict] = None,
                 payload: Any = None) -> None:
        self.path = Path(path) if path is not None else None
        self.meta: Dict = dict(meta or {})
        self._payload = payload
        self._loaded = payload is not None
        self.dirty = path is None    # new unsaved assets start dirty

    # -- payload ------------------------------------------------------
    @property
    def loaded(self) -> bool:
        return self._loaded

    @property
    def payload(self) -> Any:
        """The bulk payload; first touch loads + CRC-checks the file
        (reference lazy bin load, asset.h:46-49)."""
        if not self._loaded:
            assert self.path is not None, "unsaved asset has no file"
            kind, payload = load_asset(self.path)
            assert kind == self.kind, \
                f"asset {self.path} is '{kind}', expected '{self.kind}'"
            self._payload = self.decode(payload)
            self._loaded = True
        return self._payload

    def set_payload(self, payload: Any) -> None:
        self._payload = payload
        self._loaded = True
        self.dirty = True

    def unload(self) -> None:
        """Drop the bulk payload, keep meta (memory pressure relief)."""
        if not self.dirty:
            self._payload = None
            self._loaded = False

    # -- typed face (override points) ----------------------------------
    def decode(self, payload: Any) -> Any:
        return payload

    def encode(self) -> Any:
        return self._payload

    # -- persistence ----------------------------------------------------
    def save(self, path: Optional[Path] = None) -> None:
        p = Path(path) if path is not None else self.path
        assert p is not None, "no path for asset save"
        assert self._loaded, "saving an asset whose payload never loaded"
        save_asset(p, self.kind, self.encode(), meta=self.meta)
        self.path = p
        self.dirty = False

    @property
    def thumbnail(self):
        return decode_thumbnail(self.meta)

    @property
    def name(self) -> str:
        if "name" in self.meta:
            return str(self.meta["name"])
        return self.path.stem if self.path else "<unsaved>"


@register_kind("scene")
class SceneAsset(Asset):
    """Container face for scene files; `scene.Scene.load` consumes the
    payload dict (reference Scene : IAsset, scene/scene.h:16)."""

    def to_scene(self):
        from ..scene.scene import Scene
        return Scene.from_dict(self.payload)


class AssetManager:
    """Path-keyed registry of typed assets (reference asset.h:141).

    - `get(path)` returns the cached instance or opens the file
      header-only (meta + kind, no payload decompress).
    - `mark_dirty`/`dirty_assets`/`save_dirty` carry the reference's
      dirty-asset bookkeeping (the editor's unsaved-changes prompt).
    - `on_changed` delegates fire on insert/save (the reference's
      onAssetDirty/onAssetSaved broadcast events).
    """

    def __init__(self) -> None:
        self._assets: Dict[Path, Asset] = {}
        from ..utils.events import MultiDelegate
        self.on_changed = MultiDelegate()

    # -- lookup ---------------------------------------------------------
    def get(self, path) -> Asset:
        p = Path(path).resolve()
        a = self._assets.get(p)
        if a is None:
            kind, meta = load_meta(p)
            cls = _KIND_REGISTRY.get(kind, Asset)
            a = cls(path=p, meta=meta)
            a.kind = kind
            a.dirty = False
            self._assets[p] = a
        return a

    def insert(self, asset: Asset, path) -> Asset:
        """Adopt a new in-memory asset under a target path (unsaved)."""
        p = Path(path).resolve()
        asset.path = p
        asset.dirty = True
        self._assets[p] = asset
        self.on_changed.broadcast(asset)
        return asset

    def scan(self, root, suffix: str = ".chtp") -> Iterable[Asset]:
        """Register every asset under a directory (the content-browser
        project scan); meta only, payloads stay lazy."""
        for p in sorted(Path(root).rglob(f"*{suffix}")):
            yield self.get(p)

    def assets(self) -> Iterable[Asset]:
        return self._assets.values()

    # -- dirty tracking ---------------------------------------------------
    def mark_dirty(self, asset: Asset) -> None:
        asset.dirty = True
        self.on_changed.broadcast(asset)

    def dirty_assets(self):
        return [a for a in self._assets.values() if a.dirty]

    def save_dirty(self) -> int:
        """Save every dirty asset; -> count saved (the 'save all' action
        behind the reference's close-interception prompt)."""
        n = 0
        for a in self.dirty_assets():
            a.save()
            self.on_changed.broadcast(a)
            n += 1
        return n

    def unload_clean_payloads(self) -> None:
        """Drop payloads of clean assets (keep meta) — memory relief."""
        for a in self._assets.values():
            a.unload()
