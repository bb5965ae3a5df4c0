"""Interned name table and stable content hashes (port of
chord_tpu/utils/names.py; reference source/utils/string_table.h:11
`StringTable`, :162 `FName`, and its cityhash / crc32 helpers).

A process-global dense id per unique name (stable within a run, usable as
an int key in arrays and dicts), case-insensitive names that keep the
casing they were first registered with (FName's contract), and 64-bit
content hashes that do not change between processes (Python's `hash` is
salted per run), for keys that persist to disk. The hashes equal
chord_tpu's bit for bit: both packages key the same files.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List


class StringTable:
    """Deduplicating string registry: string -> dense int id."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._strings: List[str] = []
        self._lock = threading.Lock()

    def intern(self, s: str) -> int:
        sid = self._ids.get(s)
        if sid is not None:
            return sid
        with self._lock:
            sid = self._ids.get(s)
            if sid is None:
                sid = len(self._strings)
                self._strings.append(s)
                self._ids[s] = sid
            return sid

    def lookup(self, sid: int) -> str:
        return self._strings[sid]

    def __len__(self) -> int:
        return len(self._strings)


_GLOBAL_TABLE = StringTable()
# first-seen casing of each lower-cased name id
_DISPLAY: Dict[int, str] = {}


class Name:
    """Interned name: equality and hash by table id. Comparison ignores
    case; str() gives the casing the name was first made with."""

    __slots__ = ("_id", "_display")

    def __init__(self, s: "str | Name" = "") -> None:
        if isinstance(s, Name):
            self._id = s._id
            self._display = s._display
            return
        self._id = _GLOBAL_TABLE.intern(s.lower())
        self._display = _DISPLAY.setdefault(self._id, s)

    @property
    def id(self) -> int:
        return self._id

    def __eq__(self, other) -> bool:
        if isinstance(other, Name):
            return self._id == other._id
        if isinstance(other, str):
            return self._id == _GLOBAL_TABLE.intern(other.lower())
        return NotImplemented

    def __hash__(self) -> int:
        return self._id

    def __str__(self) -> str:
        return self._display

    def __repr__(self) -> str:
        return f"Name({self._display!r}#{self._id})"

    def __bool__(self) -> bool:
        return bool(self._display)


_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def stable_hash64(data: "bytes | str", seed: int = 0) -> int:
    """FNV-1a 64-bit over the UTF-8 bytes, the offset basis xor `seed`."""
    if isinstance(data, str):
        data = data.encode()
    h = _FNV64_OFFSET ^ seed
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h


def crc32(data: "bytes | str") -> int:
    if isinstance(data, str):
        data = data.encode()
    return zlib.crc32(data) & 0xFFFFFFFF


def combine_hash(*parts: int) -> int:
    """Order-dependent 64-bit combiner (boost hash_combine's shape)."""
    h = _FNV64_OFFSET
    for p in parts:
        h ^= (p + 0x9E3779B97F4A7C15 + ((h << 6) & _MASK64) + (h >> 2)) \
            & _MASK64
        h &= _MASK64
    return h


def intern(s: str) -> int:
    """The global table's id of a raw (case-sensitive) string."""
    return _GLOBAL_TABLE.intern(s)


def lookup(sid: int) -> str:
    return _GLOBAL_TABLE.lookup(sid)
