"""Scenes written by code: PNG layers and GLB models, with numpy and zlib.

A configuration's `"model"` names `scenes/<model>.py`, whose `glb()`
returns the GLB the program loads into its scene (`NativeWorld`'s
`glb_data`). Those files build the model from what is here:

- `png(img)`: an (H, W, 3) uint8 image as an 8-bit RGB PNG, non-interlaced,
  every row with filter 0 (None), so the reference reads it fast;
- `field(size, salt, lo, hi)`: a (size, size) uint8 field drawn from a
  hash of (x, y, salt) in integer arithmetic alone: coarse cells blended
  bilinearly plus a little fine noise, so that a bilinear sample and a box
  mip both see variation. The same bytes on every machine;
- `model(meshes, materials, images)`: a GLB of one node a mesh; each mesh
  is a `Mesh` and names its material by index; texture i reads image i.

No image library is needed, nothing is read from disk or the network, and
nothing depends on `--seed`: the seed never changes the scene.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import NamedTuple

import numpy as np

TEX = 1024  # the side of a texture layer, the port's and the upstream's


def png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, 3 * w)], axis=1).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _hash(x: np.ndarray, y: np.ndarray, salt: int) -> np.ndarray:
    """uint32 hash of integer coordinates (wrapping multiplies)."""
    h = (x.astype(np.uint32) * np.uint32(0x9E3779B1)) ^ (
        y.astype(np.uint32) * np.uint32(0x85EBCA77)) ^ np.uint32(salt)
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(12)
    h *= np.uint32(0x297A2D39)
    return h ^ (h >> np.uint32(15))


def field(size: int, salt: int, lo: int, hi: int,
          cell: int = 64) -> np.ndarray:
    """(size, size) uint8 in [lo, hi]: cells of `cell` texels, each with a
    value from the hash, blended bilinearly in fixed point, plus noise of
    1/16 of the range; it repeats with period `size`."""
    n = size // cell
    k = np.arange(n + 1)
    corner = (_hash(k[None, :], k[:, None], salt) >> np.uint32(24)) \
        .astype(np.int64)
    corner[:, n] = corner[:, 0]  # the field repeats, as the sampler wraps
    corner[n, :] = corner[0, :]
    i = np.arange(size)
    c, f = i // cell, i % cell
    along_x = corner[:, c] * (cell - f) + corner[:, c + 1] * f  # (n + 1, size)
    smooth = (along_x[c] * (cell - f)[:, None]
              + along_x[c + 1] * f[:, None]) // (cell * cell)
    fine = _hash(i[None, :], i[:, None], salt + 1) >> np.uint32(28)
    v = smooth * 15 // 16 + fine  # 0 .. 254
    return (lo + v * (hi - lo) // 254).astype(np.uint8)


def layer(salt: int, lo=(0, 0, 0), hi=(255, 255, 255)) -> bytes:
    """A TEX x TEX RGB layer as PNG, each channel a `field`."""
    return png(np.stack([field(TEX, salt + 7 * c, lo[c], hi[c])
                         for c in range(3)], axis=-1))


class Mesh(NamedTuple):
    """One primitive in world space: float32 positions (n, 3), normals
    (n, 3), uvs (n, 2), uint16 indices (m,), and its material's index."""

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray
    material: int


def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((4 - len(b) % 4) % 4)


def model(meshes: list, materials: list, images: list) -> bytes:
    """A GLB (glTF 2.0 binary): one node a mesh, texture i reading image i
    (PNG bytes), `materials` as glTF material objects."""
    blobs, accessors, prims = [], [], []
    for m in meshes:
        first = len(blobs)
        blobs += [np.asarray(m.positions, np.float32).tobytes(),
                  np.asarray(m.normals, np.float32).tobytes(),
                  np.asarray(m.uvs, np.float32).tobytes(),
                  np.asarray(m.indices, np.uint16).tobytes()]
        n = len(m.positions)
        accessors += [
            {"bufferView": first, "componentType": 5126, "count": n,
             "type": "VEC3", "min": np.min(m.positions, 0).tolist(),
             "max": np.max(m.positions, 0).tolist()},
            {"bufferView": first + 1, "componentType": 5126, "count": n,
             "type": "VEC3"},
            {"bufferView": first + 2, "componentType": 5126, "count": n,
             "type": "VEC2"},
            {"bufferView": first + 3, "componentType": 5123,
             "count": len(m.indices), "type": "SCALAR"}]
        prims.append({"attributes": {"POSITION": first, "NORMAL": first + 1,
                                     "TEXCOORD_0": first + 2},
                      "indices": first + 3, "material": m.material})
    image_views = list(range(len(blobs), len(blobs) + len(images)))
    blobs += list(images)
    offsets = np.cumsum([0] + [len(_pad4(b)) for b in blobs[:-1]]).tolist()
    bin_data = b"".join(_pad4(b) for b in blobs)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(meshes)))}],
        "nodes": [{"mesh": i} for i in range(len(meshes))],
        "meshes": [{"primitives": [p]} for p in prims],
        "buffers": [{"byteLength": len(bin_data)}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": len(b)}
                        for o, b in zip(offsets, blobs)],
        "accessors": accessors,
        "images": [{"bufferView": v, "mimeType": "image/png"}
                   for v in image_views],
        "textures": [{"source": i} for i in range(len(images))],
        "materials": materials,
    }
    js = _pad4(json.dumps(doc).encode(), b" ")
    total = 12 + 8 + len(js) + 8 + len(bin_data)
    return (struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_data), 0x004E4942) + bin_data)


def box(center, half, uv_span=(-0.25, 1.75)) -> tuple:
    """An axis-aligned box's 24 vertices (4 a face, flat normals) and 36
    indices, UVs over `uv_span` on every face (past [0, 1]: the sampler's
    repeat)."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half, np.float32)
    lo, hi = uv_span
    pos, nrm, uv, idx = [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            a, b = (axis + 1) % 3, (axis + 2) % 3
            if sign < 0:
                a, b = b, a  # keep the winding outward
            base = len(pos)
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3, np.float32)
                p[axis] = sign
                p[a], p[b] = du, dv
                pos.append(c + h * p)
                n = np.zeros(3, np.float32)
                n[axis] = sign
                nrm.append(n)
                uv.append((lo if du < 0 else hi, lo if dv < 0 else hi))
            idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32), np.asarray(idx, np.uint16))


def quad(corner, edge_u, edge_v, uv_span=(0.0, 1.0)) -> tuple:
    """A quad from `corner` along two edges (normal edge_u x edge_v)."""
    p0 = np.asarray(corner, np.float32)
    eu = np.asarray(edge_u, np.float32)
    ev = np.asarray(edge_v, np.float32)
    pos = np.stack([p0, p0 + eu, p0 + eu + ev, p0 + ev])
    n = np.cross(eu, ev)
    n = (n / np.linalg.norm(n)).astype(np.float32)
    lo, hi = uv_span
    uv = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float32)
    return (pos, np.tile(n, (4, 1)), uv,
            np.array([0, 1, 2, 0, 2, 3], np.uint16))
