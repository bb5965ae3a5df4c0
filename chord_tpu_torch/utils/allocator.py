"""Slot allocators backing the GPU scene pools.

Host-side port of chord_tpu/utils/allocator.py, the reference span allocator
(reference: source/utils/allocator/span_allocator.h — a free-list over a
growable index space that backs GPUScene slots, and
fixedsize_allocator.h for fixed blocks).

Device memory is plain tensors; the allocator hands out stable
integer element ranges inside a pool array so scene data can be updated
incrementally (scatter-upload) without re-laying-out the whole pool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class Span:
    offset: int
    count: int

    @property
    def end(self) -> int:
        return self.offset + self.count


class SpanAllocator:
    """First-fit free-list span allocator over a growable index space."""

    def __init__(self, initial_capacity: int = 0, growth_pot: bool = True) -> None:
        self._capacity = int(initial_capacity)
        self._free: List[Tuple[int, int]] = (
            [(0, self._capacity)] if self._capacity else []
        )
        self._growth_pot = growth_pot
        self._used = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def used(self) -> int:
        return self._used

    def allocate(self, count: int) -> Span:
        if count <= 0:
            raise ValueError("count must be positive")
        for i, (off, sz) in enumerate(self._free):
            if sz >= count:
                if sz == count:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + count, sz - count)
                self._used += count
                return Span(off, count)
        # Grow: extend capacity (POT growth mirrors GPUScenePool's
        # grow-and-copy behavior, reference: renderer/gpu_scene.h:21-165).
        old = self._capacity
        need = old + count
        new_cap = max(64, old * 2 if old else 64)
        while new_cap < need:
            new_cap *= 2
        if not self._growth_pot:
            new_cap = need
        self._capacity = new_cap
        self._free.append((old, new_cap - old))
        self._coalesce()
        return self.allocate(count)

    def free(self, span: Span) -> None:
        self._free.append((span.offset, span.count))
        self._used -= span.count
        self._coalesce()

    def _coalesce(self) -> None:
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for off, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        self._free = merged
