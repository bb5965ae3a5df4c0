"""Texture import, mip chain and the stacked texture pool (port of
chord_tpu/asset/texture.py; reference asset_texture_helper.cpp:24-216).

The host side is numpy, as in chord_tpu: every texture is normalised to
(size, size), its box-filtered mip chain is flattened with static offsets,
and a texture's "bindless id" is its LAYER in the stacked
(layers, total_texels, 4) pool. PIL is only needed to load or resize an
image file, so it is imported inside those functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.device import resolve
from ..utils.log import get_logger

log = get_logger("asset.texture")


def load_image(path, srgb: bool = True) -> np.ndarray:
    """File -> (H,W,4) f32 linear RGBA."""
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    a = np.asarray(img, np.float32) / 255.0
    if srgb:
        rgb = a[..., :3]
        lin = np.where(rgb <= 0.04045, rgb / 12.92,
                       ((rgb + 0.055) / 1.055) ** 2.4)
        a = np.concatenate([lin, a[..., 3:]], -1)
    return a


def build_mips(img: np.ndarray) -> List[np.ndarray]:
    """Full mip chain by 2x2 box filter."""
    mips = [img]
    cur = img
    while min(cur.shape[0], cur.shape[1]) > 1:
        h, w = cur.shape[:2]
        if h % 2 or w % 2:
            cur = np.pad(cur, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
            h, w = cur.shape[:2]
        cur = cur.reshape(h // 2, 2, w // 2, 2, -1).mean((1, 3))
        mips.append(cur)
    return mips


def _resize_pow2(img: np.ndarray, size: int) -> np.ndarray:
    """Box resample to (size, size) (import normalisation)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    from PIL import Image

    # resize channels independently (PIL premultiplies RGBA by alpha)
    chans = []
    for c in range(img.shape[-1]):
        u8 = np.clip(img[..., c] * 255.0, 0, 255).astype(np.uint8)
        out = Image.fromarray(u8, mode="L").resize((size, size),
                                                   Image.LANCZOS)
        chans.append(np.asarray(out, np.float32) / 255.0)
    return np.stack(chans, axis=-1)


@dataclass
class TextureDesc:
    name: str
    layer: int            # id handed to materials (the bindless id analog)
    src_size: Tuple[int, int]


class TexturePool:
    """Fixed-size stacked texture array + flattened mip pyramid: layer l's
    mips are concatenated with static offsets, so a runtime-chosen mip is
    index arithmetic."""

    def __init__(self, size: int = 512):
        assert size & (size - 1) == 0, "pool size must be a power of two"
        self.size = size
        self.textures: List[np.ndarray] = []   # flattened mip stacks
        self.descs: Dict[str, TextureDesc] = {}
        self.mip_sizes: List[int] = []
        self.mip_offsets: List[int] = []
        off, s = 0, size
        while s >= 1:
            self.mip_sizes.append(s)
            self.mip_offsets.append(off)
            off += s * s
            s //= 2
        self.total_texels = off

    def add(self, name: str, img: np.ndarray) -> int:
        """-> layer id."""
        if name in self.descs:
            return self.descs[name].layer
        src = img.shape[:2]
        img = _resize_pow2(img, self.size)
        mips = build_mips(img)
        flat = np.concatenate([m.reshape(-1, img.shape[-1]) for m in mips])
        assert flat.shape[0] == self.total_texels
        self.textures.append(flat.astype(np.float32))
        layer = len(self.textures) - 1
        self.descs[name] = TextureDesc(name=name, layer=layer, src_size=src)
        log.info("texture '%s' -> layer %d (%dx%d, %d mips)", name, layer,
                 self.size, self.size, len(mips))
        return layer

    def u8(self) -> np.ndarray:
        """-> (layers, total_texels, 4) u8 unorm (empty-safe): the values
        chord_tpu's device_array holds."""
        if not self.textures:
            return np.zeros((1, self.total_texels, 4), np.uint8)
        return np.clip(np.stack(self.textures) * 255.0 + 0.5, 0,
                       255).astype(np.uint8)

    def device_array(self, device=None) -> torch.Tensor:
        """-> the u8 pool as a tensor on `device` (None = the card)."""
        return torch.from_numpy(self.u8()).to(resolve(device))
