"""Plain reference of the texture sampler: a scene's texture layers, decoded
from the encoded images the scene compiler hands out, and the bilinear
sample of a `texture_2d_array` layer as the upstream shader takes it.

The rules, as the port states them (`utils/textures.py`, `ops/fetch.py`,
`ops/shade_rows.py`):

- a layer is an 8-bit RGB image of 1024^2 texels (the size every image is
  force-resized to); its values are the u8 codes / 255;
- bilinear sampling with repeat wrap at level 0: texel centres at
  (i + 0.5) / 1024, the four texels around (u, v), weights in f32;
- level 1, which bounces past the first read, is the 128^2 box mip of the
  layers (the mean of each 8 x 8 block of code / 255 values, rounded back
  to a code) when there are at most 4 layers, and level 0 itself with more;
- the bilinear lerps round as fused multiply-adds: top = fma(c1, wx,
  c0 * (1 - wx)), bottom likewise, rgb = fma(top, 1 - wy, bottom * wy);
- a lane whose texture index is below 0 reads white (1, 1, 1).

Only PNG at 1024^2 is read: any other image (a JPEG, another size, another
colour type) would need the port's decoder or its resize, which this
reference does not restate, so it raises, naming the image. Imports nothing
of the system under test.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

SIZE = 1024         # the side of a layer
MIP = 128           # the side of the box mip
MIP_LAYERS = 4      # the most layers that take the box mip


def codes(images) -> np.ndarray | None:
    """(K, SIZE, SIZE, 3) uint8 codes of the encoded images, or None when
    there are none. Raises ValueError naming the image that is not an
    8-bit RGB PNG of SIZE^2."""
    from .post import read_png  # post imports pathtrace, which imports this

    if not images:
        return None
    out = []
    for i, data in enumerate(images):
        if data[:3] == b"\xff\xd8\xff":
            raise ValueError(f"texture {i} is a JPEG: the reference reads "
                             f"PNG layers only")
        try:
            img = read_png(data)
        except (ValueError, TypeError, struct.error, zlib.error) as e:
            raise ValueError(f"texture {i} is not an 8-bit RGB PNG this "
                             f"reference reads: {e}") from e
        if img.shape != (SIZE, SIZE, 3):
            raise ValueError(f"texture {i} is {img.shape[1]}x{img.shape[0]}"
                             f": the reference samples {SIZE}^2 layers and "
                             f"restates no resize")
        out.append(img)
    return np.stack(out)


def values(c: np.ndarray) -> np.ndarray:
    """The float32 values code / 255 of codes."""
    return c.astype(np.float32) / 255.0


def levels(images) -> tuple | None:
    """(level 0, level 1) as (K, S, S, 3) uint8 codes, or None without
    images: level 1 is the box mip with at most MIP_LAYERS layers, else
    level 0 itself."""
    c = codes(images)
    if c is None or c.shape[0] > MIP_LAYERS:
        return None if c is None else (c, c)
    f = SIZE // MIP
    small = values(c).reshape(c.shape[0], MIP, f, MIP, f, 3).mean(axis=(2, 4))
    return c, np.clip(np.rint(small * 255.0), 0, 255).astype(np.uint8)


class Level:
    """One level on a device: the texel words r << 16 | g << 8 | b, flat."""

    def __init__(self, c: np.ndarray, device):
        k, s, _, _ = c.shape
        c = c.astype(np.int32)
        words = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        self.words = torch.from_numpy(words.reshape(-1)).to(device)
        self.k, self.s = k, s


def fma(a, b, c):
    """a * b + c rounded once to a's precision: the f64 product of two f32
    values is exact, and its sum rounds to the fused result but for ties
    of the double rounding."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def sample(level: Level, index, u, v) -> tuple:
    """The bilinear sample (r, g, b) of layer `index` (int32, < 0: white)
    at (u, v), in u's precision."""
    dt = u.dtype
    s = level.s
    has = index >= 0
    layer = torch.clamp(index, 0, level.k - 1).long()
    fx = (u - torch.floor(u)) * s - 0.5
    fy = (v - torch.floor(v)) * s - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    wx = fx - x0
    wy = fy - y0

    def texel(dy, dx):
        y = ((y0 + dy) % s).long()
        x = ((x0 + dx) % s).long()
        w = level.words[(layer * s + y) * s + x]
        w = torch.where(has, w, 0)
        return [((w >> sh) & 0xFF).to(torch.float32).to(dt) * (1.0 / 255.0)
                for sh in (16, 8, 0)]

    c0, c1, c2, c3 = texel(0, 0), texel(0, 1), texel(1, 0), texel(1, 1)
    out = []
    for k in range(3):
        top = fma(c1[k], wx, c0[k] * (1 - wx))
        bot = fma(c3[k], wx, c2[k] * (1 - wx))
        rgb = fma(top, 1 - wy, bot * wy)
        out.append(torch.where(has, rgb, torch.ones_like(rgb)))
    return tuple(out)
