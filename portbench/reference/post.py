"""Plain reference of the present step: the post-process chain from an
accumulator (H, W, 4) of radiance sums and sample counts and the TAA
history to the 8-bit image and the new history, and a PNG reader for the
recorder's encoded frames.

The chain, in the port's order of f32 operations: mean radiance, firefly
clamp to 3x the 3x3 neighbourhood max + 0.1, the un-jitter resample (frames
up to 16), a 3x3 bilateral filter (sigma_s 0.5, sigma_r 0.1), TAA against
the neighbourhood mean +- k sigma (k = 1, or 60 past frame 16; weight 1/frame,
0.1 on frame 1), ACES, sharpen 0.3, gamma 2.2. Imports nothing of the
system under test.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .pathtrace import sqrt_rn


def _pad(img):
    H, W, _ = img.shape
    ys = torch.arange(-1, H + 1, device=img.device).clamp(0, H - 1)
    xs = torch.arange(-1, W + 1, device=img.device).clamp(0, W - 1)
    return img[ys][:, xs]


def _at(p, dy, dx, H, W):
    return p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W, :]


def _bilinear(img, fy, fx):
    H, W, _ = img.shape
    y0 = torch.floor(fy).to(torch.int64)
    x0 = torch.floor(fx).to(torch.int64)
    wy = (fy - y0)[..., None]
    wx = (fx - x0)[..., None]

    def at(yi, xi):
        return img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]

    return ((at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx) * (1 - wy)
            + (at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx) * wy)


def _aces(c):
    return torch.clamp((c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59)
                                                  + 0.14), 0.0, 1.0)


def present(acc, history, frame: int, avg_jitter):
    """(ldr (H, W, 3) uint8, new history (H, W, 3)) of one present, in
    the accumulator's precision."""
    H, W, _ = acc.shape
    dev = acc.device
    fc = torch.full((), frame, dtype=torch.int64, device=dev)
    a = acc[..., 3:4]
    rad = torch.where(a > 0.0, acc[..., 0:3] / torch.clamp(a, min=1e-20),
                      0.0)
    p = _pad(rad)
    nb_max = torch.full_like(rad, -1e6)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb_max = torch.maximum(nb_max, _at(p, dy, dx, H, W))
    clean = torch.minimum(torch.clamp(rad, min=0.0), nb_max * 3.0 + 0.1)

    dt = acc.dtype
    jit = torch.as_tensor(np.asarray(avg_jitter, np.float32)).to(dev, dt)
    ys = torch.arange(H, dtype=dt, device=dev)[:, None] \
        * torch.ones((1, W), dtype=dt, device=dev)
    xs = torch.arange(W, dtype=dt, device=dev)[None, :] \
        * torch.ones((H, 1), dtype=dt, device=dev)
    fy = ys + 0.5 - jit[1] * H - 0.5
    fx = xs + 0.5 - jit[0] * W - 0.5
    u = torch.where(fc > 16, clean, _bilinear(clean, fy, fx))

    up = _pad(u)
    filtered = torch.zeros_like(u)
    weight = torch.zeros((H, W, 1), dtype=u.dtype, device=dev)
    m1 = torch.zeros_like(u)
    m2 = torch.zeros_like(u)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = _at(up, dy, dx, H, W)
            w_s = float(np.exp(np.float32(-(dx * dx + dy * dy)
                                          / (2.0 * 0.5 * 0.5))))
            diff = nb - u
            w = w_s * torch.exp(-torch.sum(diff * diff, dim=-1, keepdim=True)
                                / (2.0 * 0.1))
            filtered = filtered + nb * w
            weight = weight + w
            m1 = m1 + nb
            m2 = m2 + nb * nb
    denoised = filtered / torch.clamp(weight, min=1e-4)
    mean = m1 / 9.0
    std = sqrt_rn(torch.clamp(m2 / 9.0 - mean * mean, min=0.0))
    k = torch.where(fc > 16, 60.0, 1.0).to(dt)
    hist = torch.minimum(torch.maximum(history, mean - std * k),
                         mean + std * k)
    alpha = torch.clamp(torch.reciprocal(torch.clamp(
        fc.to(dt), min=1.0)), min=1e-4)
    alpha = torch.where(fc == 1, 0.1, alpha)
    final = hist + (denoised - hist) * alpha
    sharp = _aces(final) + _aces(u - denoised) * 0.3
    ldr = torch.clamp(sharp, 0.0, 1.0) ** (1.0 / 2.2)
    return (ldr * 255.0 + 0.5).to(torch.uint8), final


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG (any filter)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {tag!r}: CRC mismatch")
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = head
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"PNG {head}: only 8-bit RGB, not interlaced")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind in (1, 3, 4):
            cur = np.zeros(3 * w, np.int32)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                c = prev[x - 3] if x >= 3 else 0
                pred = (a if kind == 1 else (a + prev[x]) // 2 if kind == 3
                        else int(_paeth(np.int32(a), prev[x], np.int32(c))))
                cur[x] = (line[x] + pred) & 255
        else:
            raise ValueError(f"PNG filter {kind}")
        out[y] = prev = cur
    return out.reshape(h, w, 3).astype(np.uint8)
