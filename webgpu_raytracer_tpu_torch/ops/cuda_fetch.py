"""The row and quad fetches' wrappers: the CUDA kernels on the card, the
plain versions on the CPU.

Kernels: `csrc/fetch_rows.cu`. `wrt_fetch_rows_t` replaces the JAX
package's `ops/pallas_dense.py::_fetch_kernel` (the one-hot row fetch
launched by `pallas_fetch_t`), and `wrt_fetch_quad` replaces
`_kron_kernel` (the Kronecker quad-word fetch launched by
`pallas_fetch_kron`). Both are gathers on the card; the source says what
bounds them.

A wrapper takes the plain version (`ops/fetch.py`) only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises: there is no
fallback.
"""

from __future__ import annotations

import torch

from .. import kernels
from .fetch import fetch_quad_plain, fetch_rows_plain


def _check_index(idx: torch.Tensor, name: str, dev, n: int) -> int:
    kernels.check(idx, name, torch.int32, device=dev)
    if idx.dim() != 1:
        raise ValueError(f"{name}: shape {tuple(idx.shape)}, expected (R,)")
    if n < 1:
        raise ValueError(f"{name}: the table has no rows to fetch")
    return idx.shape[0]


def fetch_rows_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N, K) f32, idx (R,) int32 -> (K, R) f32, idx clipped to
    [0, N - 1]: bit-equal to `table[clip(idx)].T`."""
    if table.device.type == "cpu":
        return fetch_rows_plain(table, idx)
    dev = table.device
    kernels.check(table, "table", torch.float32, device=dev)
    if table.dim() != 2:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected "
                         "(N, K)")
    n, k = table.shape
    r = _check_index(idx, "idx", dev, n)
    out = torch.empty((k, r), dtype=torch.float32, device=dev)
    if r == 0 or k == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(dev):
        code = lib.wrt_fetch_rows_t(kernels.ptr(table), n, k,
                                    kernels.ptr(idx), r, kernels.ptr(out),
                                    kernels.stream(dev))
    kernels.raise_on_error(code, "fetch_rows")
    kernels.launches["fetch_rows"] += 1
    return out


def fetch_quad(flat: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """flat (N, 4) int32 quad words, rows (R,) int32 -> (R, 4) int32, rows
    clipped to [0, N - 1]."""
    if flat.device.type == "cpu":
        return fetch_quad_plain(flat, rows)
    dev = flat.device
    kernels.check(flat, "flat", torch.int32, device=dev)
    if flat.dim() != 2 or flat.shape[1] != 4:
        raise ValueError(f"flat: shape {tuple(flat.shape)}, expected (N, 4)")
    if flat.data_ptr() % 16:
        raise ValueError("flat: rows must be 16-byte aligned")
    n = flat.shape[0]
    r = _check_index(rows, "rows", dev, n)
    out = torch.empty((r, 4), dtype=torch.int32, device=dev)
    if r == 0:
        return out
    lib = kernels.library()
    with torch.cuda.device(dev):
        code = lib.wrt_fetch_quad(kernels.ptr(flat), n, kernels.ptr(rows), r,
                                  kernels.ptr(out), kernels.stream(dev))
    kernels.raise_on_error(code, "fetch_quad")
    kernels.launches["fetch_quad"] += 1
    return out
