"""Row fetches by index: shade rows and texel quad words.

The port of the JAX package's `ops/fetch.py`. On the TPU both fetches are
matmuls, because the TPU gathers slowly: `_fetch_kernel` multiplies by a
one-hot matrix, and `_kron_kernel` factors the one-hot over hi x 128 and
reads bf16x3 planes of the quad table. On a GPU both are plain gathers,
so the port keeps neither trick:

- `fetch_rows_plain(table, idx)`: (N, K) f32, idx (R,) -> (K, R), the
  transposed rows with idx clipped to [0, N - 1], bit-equal to
  `table[clip(idx)].T` (the CUDA kernel `wrt_fetch_rows_t` copies bits);
- `fetch_quad_plain(flat, rows)`: (N, 4) int32 quad words, rows (R,) ->
  (R, 4), rows clipped to [0, N - 1] (kernel `wrt_fetch_quad`).

A texture level is a `TexLevel`: the flat (N, 4) quad words as int32 (the
words are < 2^24, so they are exact in any 32-bit type) and the (K, TH, TW)
shape the sampler indexes with. It takes the place of the JAX package's
`TexKron`, which carried the same words plus its bf16x3 planes.

The bilinear sampler over a level lives here too (`texel_rows`,
`sample_texture_v3`, `tex_level`), so that both bounce loops reach it:
`ops/dense_trace.py` through the quad fetch's wrapper, and the plain
`shade_step` of `ops/shade_rows.py` through `fetch_quad_plain`.

The wrappers that pick kernel or plain version are in `ops/cuda_fetch.py`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .v3 import V3, where


class TexLevel(NamedTuple):
    """One packed quad-table texture level on a device."""

    flat: torch.Tensor  # (K * TH * TW, 4) int32 quad words
    shape: tuple        # (K, TH, TW)


def tex_level_from_np(quad: np.ndarray, device) -> TexLevel:
    """pack_quad_table output (K, TH, TW, 4) u32 -> a TexLevel on device."""
    k, th, tw, words = quad.shape
    flat = np.ascontiguousarray(quad.reshape(-1, words)).astype(np.int32)
    return TexLevel(torch.from_numpy(flat).to(device), (k, th, tw))


def device_pyramid(pyr: tuple, device) -> tuple:
    """build_quad_pyramid's numpy (level0, level1) -> (TexLevel, TexLevel)
    on device; a shared level is uploaded once."""
    l0, l1 = pyr
    d0 = tex_level_from_np(l0, device)
    if l1 is l0:
        return d0, d0
    return d0, tex_level_from_np(l1, device)


def fetch_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N, K), idx (R,) int -> (K, R): rows clipped to [0, N - 1]."""
    rows = table[idx.clamp(0, table.shape[0] - 1).long()]
    return rows.T.contiguous()


def fetch_quad_plain(flat: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """flat (N, 4) int32, rows (R,) int -> (R, 4): rows clipped."""
    return flat[rows.clamp(0, flat.shape[0] - 1).long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N, K), idx (R,) int -> (R, K). Out-of-range idx are clipped.
    The row fetch kernel on the card, its plain version on the CPU."""
    from .cuda_fetch import fetch_rows_t

    return fetch_rows_t(table, idx).T


def kron_rows(level: TexLevel, rows: torch.Tensor) -> torch.Tensor:
    """rows (R,) int32 -> (R, 4) int32 quad words of a texture level.

    The JAX package serves its secondary mip through the Kronecker one-hot
    fetch under this name; here every level is the same quad fetch."""
    from .cuda_fetch import fetch_quad

    return fetch_quad(level.flat, rows)


def tex_level(textures, level: int):
    """Resolve a texture operand that may be a (level0, level1) pyramid.

    Bounce-0 samples read the full-resolution quad table; bounces >= 1
    read the secondary mip (utils/textures.build_quad_pyramid). A bare
    TexLevel, or None (the white placeholder), serves every level."""
    if isinstance(textures, (tuple, list)) \
            and not isinstance(textures, TexLevel):
        return textures[min(level, len(textures) - 1)]
    return textures


def texel_rows(level: TexLevel, tex_idx, u, v):
    """The quad-table rows a bilinear sample reads, and its weights:
    (rows (R,) int32, wx, wy). Repeat wrap; lanes with tex_idx < 0 read
    row 0."""
    K, TH, TW = level.shape
    idx = torch.clamp(tex_idx, 0, K - 1)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    fx = uu * TW - 0.5
    fy = vv * TH - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    rows = (idx * TH + y0 % TH) * TW + x0 % TW
    rows = torch.where(tex_idx >= 0, rows, 0).to(torch.int32)
    return rows, fx - x0, fy - y0


def sample_texture_v3(textures: Optional[TexLevel], tex_idx, u, v,
                      plain: bool = False) -> V3:
    """Component-SoA bilinear texture sample; tex_idx < 0 returns white.

    `textures` is a TexLevel (packed quad table: one 16-byte row fetch
    delivers all four bilinear corners as u8 codes), or None: the 1x1
    white placeholder, or a slot the scene binds nowhere, which both
    sample as white. Lanes with no texture fetch row 0, and their value is
    discarded. The rows come through the quad fetch's wrapper (`kron_rows`:
    the kernel on the card), or with plain=True through `fetch_quad_plain`
    on any device."""
    one = torch.ones_like(u)
    if textures is None:
        return V3(one, one, one)
    has = tex_idx >= 0
    rows, wx, wy = texel_rows(textures, tex_idx, u, v)
    q = fetch_quad_plain(textures.flat, rows) if plain \
        else kron_rows(textures, rows)

    def corner(c):
        w = q[:, c]
        return V3(((w >> 16) & 0xFF).to(torch.float32),
                  ((w >> 8) & 0xFF).to(torch.float32),
                  (w & 0xFF).to(torch.float32)) * (1.0 / 255.0)

    c0, c1, c2, c3 = (corner(c) for c in range(4))
    top = _fma_v3(c1, wx, c0 * (1 - wx))
    bot = _fma_v3(c3, wx, c2 * (1 - wx))
    rgb = _fma_v3(top, 1 - wy, bot * wy)
    return where(has, rgb, V3(one, one, one))


def _fma_v3(a: V3, b, c: V3) -> V3:
    """a * b + c with one rounding to f32, per component.

    The JAX package's sampler body is one compiled XLA computation, whose
    CPU backend contracts the bilinear lerps into fused multiply-adds:
    top = fma(c1, wx, c0 * (1 - wx)), likewise bot, and
    rgb = fma(top, 1 - wy, bot * wy). The port rounds the same way on any
    device: the product of two f32 values is exact in f64, and the f64
    sum rounds to the f32 fma result except when that double rounding lands
    on an f32 tie (about one lane in 2^28)."""
    bd = b.double()
    return V3(*((x.double() * bd + z.double()).float()
                for x, z in zip(a, c)))
