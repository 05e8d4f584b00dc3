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

The wrappers that pick kernel or plain version are in `ops/cuda_fetch.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
