"""Binary asset container: versioned header + compression + checksum (port of
chord_tpu/asset/serialize.py).

The port of the reference's cereal+LZ4 asset serialization
(reference: source/asset/serialize.h:194-266 — saveAsset/loadAsset with a
versioned AssetCompressedMeta wrapper, LZ4-compressed cereal binary
archives). Here: a magic/version header, zlib-compressed payload (numpy
arrays as raw buffers + JSON metadata), and a CRC32 integrity check —
the same contract (versioned, compressed, checksummed, partial-load of
meta without the bulk payload).

Layout:
    magic  b"CHTP"  | u32 version | u32 kind_len | kind utf-8
    u32 meta_len    | meta JSON (uncompressed — loadable without payload)
    u32 crc32       | u64 raw_len | zlib payload
Payload = JSON document where numpy arrays are replaced by {"__nd__": i}
references into an array pack appended after the JSON.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

MAGIC = b"CHTP"
VERSION = 1


def _encode_payload(doc: Any) -> bytes:
    """JSON + raw ndarray pack."""
    arrays = []

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [strip(v) for v in x]
        if isinstance(x, np.ndarray):
            arrays.append(np.ascontiguousarray(x))
            return {"__nd__": len(arrays) - 1}
        if isinstance(x, (np.floating, np.integer)):
            return x.item()
        return x

    body = json.dumps(strip(doc)).encode()
    out = io.BytesIO()
    out.write(struct.pack("<I", len(body)))
    out.write(body)
    out.write(struct.pack("<I", len(arrays)))
    for a in arrays:
        dt = np.lib.format.dtype_to_descr(a.dtype).encode()
        out.write(struct.pack("<I", len(dt)))
        out.write(dt)
        out.write(struct.pack("<I", a.ndim))
        out.write(struct.pack(f"<{a.ndim}q", *a.shape))
        raw = a.tobytes()
        out.write(struct.pack("<Q", len(raw)))
        out.write(raw)
    return out.getvalue()


def _decode_payload(raw: bytes) -> Any:
    buf = io.BytesIO(raw)
    (blen,) = struct.unpack("<I", buf.read(4))
    doc = json.loads(buf.read(blen))
    (n_arr,) = struct.unpack("<I", buf.read(4))
    arrays = []
    for _ in range(n_arr):
        (dlen,) = struct.unpack("<I", buf.read(4))
        dt = np.dtype(buf.read(dlen).decode())
        (ndim,) = struct.unpack("<I", buf.read(4))
        shape = struct.unpack(f"<{ndim}q", buf.read(8 * ndim))
        (rlen,) = struct.unpack("<Q", buf.read(8))
        arrays.append(np.frombuffer(buf.read(rlen), dt).reshape(shape))

    def restore(x):
        if isinstance(x, dict):
            if "__nd__" in x and len(x) == 1:
                return arrays[x["__nd__"]]
            return {k: restore(v) for k, v in x.items()}
        if isinstance(x, list):
            return [restore(v) for v in x]
        return x

    return restore(doc)


def encode_thumbnail(img_u8: np.ndarray, max_size: int = 128) -> str:
    """(H,W,3) u8 -> base64 PNG string for the asset meta header — the
    reference's snapshot/thumbnail system (asset.h snapshot data kept in
    the always-loaded meta; the editor content browser reads it without
    touching the bulk payload)."""
    import base64

    from PIL import Image

    img = Image.fromarray(np.ascontiguousarray(img_u8))
    img.thumbnail((max_size, max_size))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def decode_thumbnail(meta: Dict) -> Optional[np.ndarray]:
    """meta dict -> (h,w,3) u8 thumbnail or None."""
    import base64

    from PIL import Image

    b64 = meta.get("thumbnail")
    if not b64:
        return None
    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    return np.asarray(img)


def save_asset(path: Path, kind: str, payload: Any,
               meta: Optional[Dict] = None) -> None:
    """Write a versioned compressed asset (reference saveAsset)."""
    raw = _encode_payload(payload)
    comp = zlib.compress(raw, level=6)
    meta_b = json.dumps(meta or {}).encode()
    kind_b = kind.encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<I", len(kind_b)))
        f.write(kind_b)
        f.write(struct.pack("<I", len(meta_b)))
        f.write(meta_b)
        f.write(struct.pack("<I", zlib.crc32(raw) & 0xFFFFFFFF))
        f.write(struct.pack("<Q", len(raw)))
        f.write(comp)


def load_meta(path: Path) -> Tuple[str, Dict]:
    """Header-only load (the reference keeps asset meta always loaded and
    the bulk lazy, asset.h:46-49)."""
    with open(path, "rb") as f:
        assert f.read(4) == MAGIC, "bad asset magic"
        (ver,) = struct.unpack("<I", f.read(4))
        assert ver <= VERSION, f"asset version {ver} too new"
        (klen,) = struct.unpack("<I", f.read(4))
        kind = f.read(klen).decode()
        (mlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(mlen))
    return kind, meta


def load_asset(path: Path) -> Tuple[str, Any]:
    """Full load with CRC verification (reference loadAsset)."""
    with open(path, "rb") as f:
        assert f.read(4) == MAGIC, "bad asset magic"
        (ver,) = struct.unpack("<I", f.read(4))
        assert ver <= VERSION, f"asset version {ver} too new"
        (klen,) = struct.unpack("<I", f.read(4))
        kind = f.read(klen).decode()
        (mlen,) = struct.unpack("<I", f.read(4))
        _meta = json.loads(f.read(mlen))
        (crc,) = struct.unpack("<I", f.read(4))
        (raw_len,) = struct.unpack("<Q", f.read(8))
        raw = zlib.decompress(f.read(), bufsize=raw_len)
    assert (zlib.crc32(raw) & 0xFFFFFFFF) == crc, "asset CRC mismatch"
    return kind, _decode_payload(raw)
