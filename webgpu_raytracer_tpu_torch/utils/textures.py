"""Texture decoding and packing: encoded bytes -> bilinear quad tables.

The port of the JAX package's `utils/textures.py`, with the same names and
results, but without PIL: the JAX package decodes with Pillow, which the
port does not depend on. Here

- PNG is read with `zlib` and numpy: every colour type (grey, RGB,
  palette, grey+alpha, RGBA) at every bit depth PNG allows it (1, 2, 4, 8
  and 16 for grey, 1-8 for palette, 8 and 16 otherwise), non-interlaced
  or Adam7, row filters 0-4, and converted to RGB as Pillow's
  `convert("RGB")` does: grey replicated (sub-byte grey scaled to 0-255,
  16-bit grey, Pillow's mode I;16, clipped to 255), 16-bit colour by its
  high byte, palette looked up (indices past PLTE give 0), alpha dropped;
  tRNS, gAMA, sRGB and iCCP are ignored, as there;
- JPEG (baseline, extended and progressive Huffman) is read by
  `utils/jpeg.py`, which restates libjpeg-turbo and Pillow's conversion;
- the force-resize to TEX_SIZE^2 restates Pillow's bilinear `resize`: a
  horizontal pass then a vertical pass over u8 pixels, each with
  triangle-filter coefficients normalised per output pixel and held in
  fixed point with 22 fraction bits, accumulated from a rounding bias of
  2^21 and clipped to u8. Both give Pillow's bytes exactly.

Bytes that are no image, and damaged PNG or JPEG (truncated, a bad table
or code, a colour type at a bit depth PNG does not allow), fall back to
the reference's flat 0.8 fill. Images the decoder does not read (GIF,
BMP, WebP, TIFF, which glTF does not carry; lossless, hierarchical,
arithmetic-coded or 12-bit JPEG) raise NotImplementedError naming the
format, rather than rendering a grey that might pass for a texture.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from .jpeg import decode_jpeg

TEX_SIZE = 1024

# Secondary-bounce mip size: bounces >= 1 sample a 128^2 box mip when it
# fits KRON_MAX_ROWS rows (k * 128^2 <= 65536, i.e. up to 4 layers); with
# more layers both levels alias the full-resolution table. The rule is the
# JAX package's, kept so the port renders the same images.
SECONDARY_MIP = 128
KRON_MAX_ROWS = 65536

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"),
                  (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                  (b"MM\x00*", "TIFF"))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}  # the bit depths PNG allows each colour type
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # (x0, y0, dx, dy)
_PRECISION_BITS = 22  # Pillow's fixed-point resample precision (8 bpc)


def _format_of(data: bytes) -> str | None:
    if data.startswith(_PNG_SIG):
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return None


def _unfilter(raw: np.ndarray, pos: int, height: int, stride: int,
              bpp: int) -> tuple[np.ndarray, int]:
    """Undo PNG's per-row filters on `height` rows of `stride` bytes
    starting at raw[pos]: ((height, stride) u8, the position after).
    Rows are whole multiples of `bpp` bytes: below 8 bits bpp is 1."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        if pos + 1 + stride > raw.size:
            raise ValueError("PNG: image data truncated")
        ftype = int(raw[pos])
        line = raw[pos + 1:pos + 1 + stride].astype(np.int64)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: a running sum along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:    # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: byte-serial
            cur_l = [0] * stride
            line_l = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur_l[i] = (line_l[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prior = cur
    return out, pos


def _samples(rows: np.ndarray, width: int, ch: int, depth: int):
    """Unfiltered rows (h, stride) u8 -> (h, width, ch) int64 samples:
    big-endian at 16 bits, MSB first below 8 (rows are byte-padded)."""
    h = rows.shape[0]
    n = width * ch
    if depth == 16:
        hi = rows[:, 0:2 * n:2].astype(np.int64)
        return ((hi << 8) | rows[:, 1:2 * n:2]).reshape(h, width, ch)
    if depth == 8:
        return rows[:, :n].astype(np.int64).reshape(h, width, ch)
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (bits.astype(np.int64) @ weights).reshape(h, width, ch)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) u8 RGB, as Pillow's open + convert("RGB").

    Raises ValueError (or zlib.error) for malformed data."""
    pos = len(_PNG_SIG)
    ihdr = None
    palette = None
    idat = []
    while pos + 12 <= len(data):  # chunks up to IEND or the data's end
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) != 4 or struct.unpack(">I", crc)[0] != (
                zlib.crc32(ctype + body) & 0xFFFFFFFF):
            raise ValueError(f"PNG: {ctype!r} chunk truncated or corrupt")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG: no IHDR or IDAT chunk")
    width, height, depth, ctype, _, _, interlace = ihdr
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"PNG: colour type {ctype} at bit depth {depth}")
    if interlace > 1:
        raise ValueError(f"PNG: unknown interlace method {interlace}")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = np.zeros((height, width, ch), np.int64)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:  # an empty pass has no bytes at all
            continue
        rows, pos = _unfilter(raw, pos, ph, -(-pw * ch * depth // 8), bpp)
        px[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if depth == 16:
        # Pillow opens 16-bit grey as I;16 and clips it to 255; every
        # other 16-bit mode keeps the high byte.
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        px = np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3], np.uint8)


def _resample_coeffs(in_size: int, out_size: int):
    """Pillow's bilinear coefficients for one axis: (first source index
    (out,), fixed-point weights (out, ksize) int64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            d = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - d if d < 1.0 else 0.0)
        ww = 0.0
        for w in ws:  # in order, as Pillow accumulates
            ww += w
        for x, w in enumerate(ws):
            k = w / ww if ww != 0.0 else w
            scaled = k * (1 << _PRECISION_BITS)
            kk[xx, x] = int(scaled - 0.5) if k < 0 else int(0.5 + scaled)
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One Pillow pass along `axis` (0 rows, 1 columns) of an (H, W, C) u8
    image."""
    in_size = img.shape[axis]
    first, kk = _resample_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    extra = (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        rows = np.minimum(first + x, in_size - 1)  # zero weight past the end
        acc += src[rows] * kk[:, x].reshape((-1,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) u8 -> (size, size, 3) u8, as Pillow's
    `resize((size, size), Image.BILINEAR)`."""
    h, w = img.shape[:2]
    if w != size:
        img = _resample_axis(img, size, 1)
    if h != size:
        img = _resample_axis(img, size, 0)
    return np.ascontiguousarray(img)


def decode_texture(data: bytes, size: int = TEX_SIZE) -> np.ndarray:
    """Decode one image to (size, size, 3) float32 in [0, 1]."""
    fmt = _format_of(data)
    if fmt is None:
        # no image: the reference's fallback texture
        return np.full((size, size, 3), 0.8, np.float32)
    if fmt not in ("PNG", "JPEG"):
        raise NotImplementedError(
            f"{fmt} texture: the decoder reads PNG and JPEG only")
    try:
        rgb = decode_png(data) if fmt == "PNG" else decode_jpeg(data)
    except (ValueError, zlib.error):
        # a damaged image does not open: the reference's fallback texture
        return np.full((size, size, 3), 0.8, np.float32)
    return np.asarray(resize_bilinear(rgb, size), np.float32) / 255.0


def decode_world_textures(world, size: int = TEX_SIZE) -> np.ndarray | None:
    """Decode all of a NativeWorld's textures; None when it has none."""
    count = world.texture_count()
    if count == 0:
        return None
    layers = []
    for i in range(count):
        data = world.texture(i)
        if data:
            layers.append(decode_texture(data, size))
        else:
            layers.append(np.ones((size, size, 3), np.float32))
    return np.stack(layers)


def pack_quad_table(tex: np.ndarray) -> np.ndarray:
    """(K, S, S, 3) f32 in [0,1] -> (K, S, S, 4) uint32 bilinear quad table.

    Word c of row (k, y, x) packs corner c of the bilinear quad at (y, x)
    (repeat-mode neighbours via roll) as r<<16 | g<<8 | b u8 codes, so a
    bilinear sample is one 16-byte row fetch plus bit unpacking. The codes
    reconstruct rgba8unorm texels exactly (code / 255 in f32)."""
    codes = np.clip(np.rint(tex * 255.0), 0, 255).astype(np.uint32)
    c00 = codes
    c10 = np.roll(codes, -1, axis=2)
    c01 = np.roll(codes, -1, axis=1)
    c11 = np.roll(c10, -1, axis=1)
    words = [
        (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        for c in (c00, c10, c01, c11)
    ]
    return np.stack(words, axis=-1)


def build_quad_pyramid(tex: np.ndarray,
                       mip: int | None = SECONDARY_MIP) -> tuple:
    """(K, S, S, 3) f32 -> (level0, level1) packed quad tables (numpy).

    level0 is pack_quad_table at full resolution (primary hits, G-buffer
    seeded bounce 0); level1 is a box-downsampled mip for bounces >= 1,
    or level0 itself when mip is None, the texture is no larger than the
    mip, or k * mip^2 > KRON_MAX_ROWS."""
    l0 = pack_quad_table(tex)
    k, s = tex.shape[0], tex.shape[1]
    if mip is None or s <= mip or k * mip * mip > KRON_MAX_ROWS:
        return l0, l0
    f = s // mip
    small = tex[:, : mip * f, : mip * f].reshape(k, mip, f, mip, f, 3) \
        .mean(axis=(2, 4))
    return l0, pack_quad_table(small)
