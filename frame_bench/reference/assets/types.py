"""Host-side asset types: meshes, surfaces, materials, texture library.

Numpy port of ``syzygy_tpu/assets/types.py`` (``assets/assets.hpp:30-244``).
Textures keep their native resolutions and are packed into ONE plain
``(A_h, A_w, 4)`` atlas with a per-texture rect table (optionally with a
mip pyramid per texture, :meth:`TextureLibrary.as_atlas_mips`); the TPU's
quad and joint atlas packings (gather-count workarounds, bitwise-neutral)
are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class MaterialData:
    """Texture ids for one surface (``renderer/material.hpp:16-24``)."""

    color: int
    normal: int
    orm: int


@dataclasses.dataclass(frozen=True)
class GeometrySurface:
    """Triangle range + material."""

    first_tri: int
    tri_count: int
    material: MaterialData


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh, SoA host arrays."""

    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    uvs: np.ndarray  # (V, 2) f32
    colors: np.ndarray  # (V, 4) f32
    triangles: np.ndarray  # (T, 3) i32
    surfaces: list[GeometrySurface]
    name: str = "mesh"

    @property
    def vertex_bounds(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        self.normals = np.ascontiguousarray(self.normals, np.float32)
        self.uvs = np.ascontiguousarray(self.uvs, np.float32)
        self.colors = np.ascontiguousarray(self.colors, np.float32)
        self.triangles = np.ascontiguousarray(self.triangles, np.int32)


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """sRGB EOTF (inverse of ``shaders/transfer/oetf_srgb.comp``)."""
    srgb = srgb.astype(np.float32)
    return np.where(
        srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    """sRGB OETF, inverse of :func:`srgb_to_linear`: the reference's f32
    arithmetic (``syzygy_tpu/assets/types.py:75``, and its copy in
    ``gltf_export.py:26``, which computes the same)."""
    linear = np.clip(linear.astype(np.float32), 0.0, 1.0)
    return np.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * linear ** (1.0 / 2.4) - 0.055,
    ).astype(np.float32)


class TextureLibrary:
    """Registry of native-resolution float32 (linear light) textures.

    ``max_size`` caps oversized inputs (bilinear downsample); smaller
    textures are stored as-is."""

    def __init__(self, max_size: int = 1024):
        self.max_size = max_size
        self._textures: list[np.ndarray] = []
        self._names: dict[str, int] = {}
        self._srgb: list[bool] = []

    def register(self, name: str, rgba: np.ndarray, srgb: bool = False, replace: bool = False) -> int:
        """Add a texture; uint8 input is normalized, sRGB-decoded if flagged
        (color maps are sRGB, normal/ORM maps linear UNORM). A registered
        ``name`` returns its existing index untouched unless ``replace``,
        which decodes the new texels and sRGB flag into the same index
        (the reference's image dialog re-reads the file each time)."""
        if name in self._names and not replace:
            return self._names[name]
        img = np.asarray(rgba)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError(f"expected (H, W, 4) texture, got {img.shape}")
        if srgb:
            img = np.concatenate(
                [srgb_to_linear(img[..., :3]), img[..., 3:]], axis=-1
            )
        h, w = img.shape[:2]
        if max(h, w) > self.max_size:
            s = self.max_size / max(h, w)
            img = _resize_bilinear(
                img, max(int(round(h * s)), 1), max(int(round(w * s)), 1)
            )
        img = np.ascontiguousarray(img, np.float32)
        if name in self._names:
            idx = self._names[name]
            self._textures[idx], self._srgb[idx] = img, srgb
            return idx
        self._textures.append(img)
        self._srgb.append(srgb)
        self._names[name] = len(self._textures) - 1
        return self._names[name]

    def lookup(self, name: str) -> Optional[int]:
        return self._names.get(name)

    def is_srgb(self, idx: int) -> bool:
        """Whether the texture was sRGB-decoded when registered: display
        paths encode such texels with the OETF again."""
        return self._srgb[idx]

    def names(self) -> list[str]:
        """Registered names in index order (``ui/texturedisplay.cpp:21-80``)."""
        ordered = [""] * len(self._textures)
        for name, idx in self._names.items():
            ordered[idx] = name
        return ordered

    def get(self, idx: int) -> np.ndarray:
        """The texture at native resolution, (H, W, 4) f32 linear light."""
        return self._textures[idx]

    def as_atlas(self) -> tuple[np.ndarray, np.ndarray]:
        """Shelf-pack every texture into one atlas (the reference's layout,
        so rects agree): (atlas (A_h, A_w, 4) f32, rects (N, 4) i32
        [x0, y0, w, h])."""
        if not self._textures:
            return np.zeros((8, 128, 4), np.float32), np.asarray(
                [[0, 0, 1, 1]], np.int32
            )
        order = sorted(
            range(len(self._textures)),
            key=lambda i: -self._textures[i].shape[0],
        )
        max_w = max(t.shape[1] for t in self._textures)
        width = 128
        while width < max_w:
            width *= 2
        total_area = sum(t.shape[0] * t.shape[1] for t in self._textures)
        while width * width < total_area and width < 8192:
            width *= 2

        rects = np.zeros((len(self._textures), 4), np.int64)
        shelf_y = shelf_h = cursor_x = 0
        for i in order:
            h, w = self._textures[i].shape[:2]
            if cursor_x + w > width:
                shelf_y += shelf_h
                shelf_h = 0
                cursor_x = 0
            rects[i] = (cursor_x, shelf_y, w, h)
            cursor_x += w
            shelf_h = max(shelf_h, h)
        height = (shelf_y + shelf_h + 7) // 8 * 8

        atlas = np.zeros((height, width, 4), np.float32)
        for i, tex in enumerate(self._textures):
            x0, y0, w, h = rects[i]
            atlas[y0 : y0 + h, x0 : x0 + w] = tex
        return atlas, rects.astype(np.int32)

    def as_atlas_mips(self, levels: int = 6) -> tuple[np.ndarray, np.ndarray]:
        """Pack a mip pyramid of every texture into one atlas (the
        reference's beyond-parity option): (atlas (A_h, A_w, 4) f32, rects
        (N, levels, 4) i32), ``rects[i, l]`` texture i's level-l placement.
        Level l is the bilinear half-size reduction of level l-1, reduced
        before packing so no level crosses a texture border; a texture
        that bottoms out at 1x1 repeats its last level."""
        pyramids: list[list[np.ndarray]] = []
        for tex in self._textures or [np.zeros((1, 1, 4), np.float32)]:
            chain = [tex]
            for _ in range(levels - 1):
                h, w = chain[-1].shape[:2]
                if h == 1 and w == 1:
                    chain.append(chain[-1])
                else:
                    chain.append(_resize_bilinear(chain[-1], max(h // 2, 1), max(w // 2, 1)))
            pyramids.append(chain)
        packer = TextureLibrary(max_size=self.max_size)
        packer._textures = [img for chain in pyramids for img in chain]
        atlas, flat_rects = packer.as_atlas()
        return atlas, flat_rects.reshape(len(pyramids), levels, 4)

    def __len__(self) -> int:
        return len(self._textures)


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize, texel-center aligned."""
    h, w, _ = img.shape
    if (h, w) == (out_h, out_w):
        return img

    def axis_coords(n_in, n_out):
        x = (np.arange(n_out, dtype=np.float32) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0.0, n_in - 1)
        lo = np.floor(x).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (x - lo).astype(np.float32)

    ylo, yhi, yf = axis_coords(h, out_h)
    xlo, xhi, xf = axis_coords(w, out_w)
    xf = xf[None, :, None]
    top = img[ylo][:, xlo] * (1 - xf) + img[ylo][:, xhi] * xf
    bot = img[yhi][:, xlo] * (1 - xf) + img[yhi][:, xhi] * xf
    return (top * (1 - yf)[:, None, None] + bot * yf[:, None, None]).astype(
        np.float32
    )
