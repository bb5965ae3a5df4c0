"""Delegates / events + LRU cache (port of chord_tpu/utils/events.py).

The reference's delegate utilities (reference:
source/utils/delegate.h:82,178 — Delegate (single), MultiDelegates
(broadcast with result fold), ChordEvent) and utils/lru.h. Used by the
host layer: asset hot-reload hooks, scene load/unload notifications,
cvar change fanout.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Delegate:
    """Single-binding callable slot (reference: Delegate)."""

    def __init__(self) -> None:
        self._fn: Optional[Callable] = None

    def bind(self, fn: Callable) -> None:
        self._fn = fn

    def unbind(self) -> None:
        self._fn = None

    @property
    def bound(self) -> bool:
        return self._fn is not None

    def __call__(self, *args, **kwargs):
        if self._fn is None:
            return None
        return self._fn(*args, **kwargs)


class MultiDelegate:
    """Broadcast to many handlers, optionally folding results
    (reference: MultiDelegates with result fold)."""

    def __init__(self) -> None:
        self._handlers: List[Callable] = []

    def add(self, fn: Callable) -> Callable:
        self._handlers.append(fn)
        return fn   # usable as a decorator

    def remove(self, fn: Callable) -> None:
        self._handlers.remove(fn)

    def __len__(self) -> int:
        return len(self._handlers)

    def broadcast(self, *args, **kwargs) -> list:
        return [fn(*args, **kwargs) for fn in list(self._handlers)]

    def fold(self, fold_fn: Callable[[Any, Any], Any], init: Any,
             *args, **kwargs) -> Any:
        acc = init
        for r in self.broadcast(*args, **kwargs):
            acc = fold_fn(acc, r)
        return acc


class Event(MultiDelegate):
    """One-shot-armable broadcast (reference: ChordEvent — e.g. the
    window-close interception used for unsaved-scene protection)."""

    def broadcast_until_handled(self, *args, **kwargs) -> bool:
        """Returns True as soon as any handler returns truthy."""
        for fn in list(self._handlers):
            if fn(*args, **kwargs):
                return True
        return False


class LRUCache(Generic[T]):
    """Bounded LRU (reference: utils/lru.h). Used for meshlet-build and
    texture-import caches keyed by content hash."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._d: "OrderedDict[Any, T]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Optional[T]:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value: T) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d
