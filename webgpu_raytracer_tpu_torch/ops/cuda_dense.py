"""The sweep's entry points: closest hit with winner rows, and any-hit
occlusion, dispatched by tile count as the JAX package's `_run` does.

- A scene whose padded triangle count is at most 128 (one tile) takes
  `csrc/dense_sweep.cu`, which replaces the JAX package's
  `ops/pallas_dense.py::_kernel` (the single-tile sweep launched by
  `_run`). Its source says what bounds it on the card (instruction issue,
  as measured) and what the design does about that.
- Every multi-tile scene takes one of two narrow phases behind the
  coherence sort, chosen by the caller's `narrow` as the JAX package's
  `TuneConfig.narrow` chooses `_run3` or `_run2`: `"jobs"` (the default) is
  the job-stream path (`ops/cuda_jobs.py`: exact cluster cull,
  `csrc/job_sweep.cu`), `"scan"` the scan path (`ops/cuda_scan.py`: keyed
  near-to-far cull, `csrc/scan_sweep.cu`). Both write their outputs in the
  caller's lane order and give the same t, idx, rows and occlusion bit for
  bit. The rule is the same on both devices; a single-tile scene ignores
  `narrow`.

A wrapper takes the plain versions (`ops/dense.py`, and the two paths')
only for tensors on the CPU. For CUDA tensors it launches the kernels or
raises: there is no fallback. `full_sweep` walks every tile with
`dense_sweep.cu` whatever the tile count: `chip_smoke.py` holds both
multi-tile paths against it.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import cuda_jobs, cuda_scan
from .dense import TRI_CHUNK, T_MIN, closest_plain, rows_plain, shadow_plain
from ..render.worldtris import FEAT_K, SHADE_K, WorldTables


NARROW = {"jobs": cuda_jobs, "scan": cuda_scan}


def multi_tile(tables: WorldTables) -> bool:
    """More than one 128-triangle tile: the scenes of the job-stream and
    scan paths."""
    return tables.features.shape[-1] // 5 > TRI_CHUNK


def _narrow_phase(narrow: str):
    """The module of a multi-tile narrow phase; raises on an unknown one."""
    if narrow not in NARROW:
        raise ValueError(f"narrow {narrow!r}: one of {sorted(NARROW)}")
    return NARROW[narrow]


def _check_tables(tables: WorldTables, device) -> int:
    """Raise unless the tables fit the kernel; returns the padded tri count."""
    tw = tables.features.shape[-1] // 5
    kernels.check(tables.features, "features", torch.float32,
                  (FEAT_K, 5 * tw), device)
    kernels.check(tables.shade_table, "shade_table", torch.float32,
                  (tw, SHADE_K), device)
    if not 0 <= tables.valid_count <= tw:
        raise ValueError(f"valid_count {tables.valid_count} outside "
                         f"[0, {tw}]")
    return tw


def _launch(tables: WorldTables, rays8: torch.Tensor, any_hit: bool,
            row_from_lane: int = 0):
    dev = rays8.device
    kernels.check(rays8, "rays8", torch.float32, device=dev)
    if rays8.dim() != 2 or rays8.shape[0] != 8:
        raise ValueError(f"rays8: shape {tuple(rays8.shape)}, expected (8, R)")
    tw = _check_tables(tables, dev)
    R = rays8.shape[1]
    if not 0 <= row_from_lane <= R:
        raise ValueError(f"row_from_lane {row_from_lane} outside [0, {R}]")
    t = idx = rows = occ = None
    if any_hit:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
    else:
        t = torch.empty(R, dtype=torch.float32, device=dev)
        idx = torch.empty(R, dtype=torch.int32, device=dev)
        rows = torch.empty((SHADE_K, R - row_from_lane),
                           dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        code = lib.wrt_dense_sweep(
            kernels.ptr(tables.features), tw, tables.valid_count,
            kernels.ptr(tables.shade_table), kernels.ptr(rays8), R, T_MIN,
            int(any_hit), row_from_lane,
            kernels.ptr(t), kernels.ptr(idx), kernels.ptr(rows),
            kernels.ptr(occ), kernels.stream(dev))
    kernels.raise_on_error(code, "dense_sweep")
    kernels.launches["dense_sweep"] += 1
    return occ if any_hit else (t, idx, rows)


def full_sweep(tables: WorldTables, rays8: torch.Tensor, any_hit: bool,
               row_from_lane: int = 0):
    """Every tile, in one sweep: `dense_sweep.cu` on the card, the plain
    version on the CPU. Occlusion when any_hit, else (t, idx, rows)."""
    if rays8.device.type == "cpu":
        if any_hit:
            return shadow_plain(tables, rays8)
        t, idx = closest_plain(tables, rays8)
        return t, idx, rows_plain(tables.shade_table, idx[row_from_lane:])
    return _launch(tables, rays8, any_hit, row_from_lane)


def closest_with_row(tables: WorldTables, rays8: torch.Tensor,
                     row_from_lane: int = 0, narrow: str = "jobs"):
    """Closest hit plus winner rows: (t (R,), idx (R,) int32,
    rows (SHADE_K, R - row_from_lane)).

    Rows cover lanes [row_from_lane:] only: the fused per-bounce call packs
    the shadow lanes first, and they never read rows. `narrow` ("jobs" |
    "scan") picks a multi-tile scene's narrow phase."""
    phase = _narrow_phase(narrow)
    if multi_tile(tables):
        return phase.closest_with_row(tables, rays8, row_from_lane)
    return full_sweep(tables, rays8, False, row_from_lane)


def shadow(tables: WorldTables, rays8: torch.Tensor, narrow: str = "jobs"):
    """Any-hit occlusion: bool (R,)."""
    phase = _narrow_phase(narrow)
    if multi_tile(tables):
        return phase.shadow(tables, rays8)
    return full_sweep(tables, rays8, True)
