"""The scan path of multi-tile scenes: coherence sort, keyed near-to-far
cull, scan narrow phase; the CUDA kernels on the card, their plain versions
on the CPU.

The port of the JAX package's `ops/pallas_dense.py::_run2`, which serves a
multi-tile scene there when `TuneConfig.narrow == "scan"`; here
`ops/cuda_dense.py` dispatches to it for `narrow="scan"` (the default,
`"jobs"`, is `ops/cuda_jobs.py`):

1. `ops/coherence.coherence_sort` pads the (8, R) ray stack to a multiple
   of m = `tune.M_TILE2` lanes and sorts the lanes (shared with the job
   path; plain PyTorch on both devices);
2. the cull gives each m-lane ray tile its keys, the least world distance
   at which a lane of the tile can touch each cluster:
   `csrc/cluster_cull.cu` (`cluster_cull_keyed`), or `ops/cluster_cull.
   keys_plain` on the CPU; with `cull="cone"` the conservative cone cull
   `cone_worklists_plain` (plain PyTorch on both devices, as it is XLA in
   the JAX package). One `torch.sort` of the (T, Ct) keys orders each
   tile's survivors near to far, as the JAX package's `argsort` does
   outside any kernel;
3. the narrow phase scans each tile's worklist: `csrc/scan_sweep.cu`
   (`scan_sweep`, replacing `_kernel2`), or `ops/dense.scan_closest_plain`
   / `scan_shadow_plain` on the CPU;
4. outputs come back in the caller's lane order: the kernel writes them
   there through the permutation, the plain path scatters them.

Keys, counts and worklists stay on the device and the grids are fixed by R,
so a sweep makes no host sync and one launch of each kernel. For CUDA
tensors the wrappers launch the kernels or raise: there is no fallback,
neither to the plain versions, nor to the job path, nor to
`dense_sweep.cu`'s walk over every tile. Nothing above this module passes
`m` or `cull`: they are arguments because the JAX package's tests run its
scan path at `m_tile2=512` and with `exact_cull=False`, and the port's
tests hold it to them.
"""

from __future__ import annotations

import torch

from .. import kernels
from .cluster_cull import (A_LO_SCALE, HI_NUDGE, cone_worklists_plain,
                           keys_plain, sort_keyed)
from .coherence import coherence_sort
from .cuda_jobs import (check_sorted, check_spheres, check_tables,
                        unpermute)
from .dense import T_MIN, rows_plain, scan_closest_plain, scan_shadow_plain
from .tune import M_TILE2
from ..render.worldtris import SHADE_K, WorldTables


def cluster_keys(spheres: torch.Tensor, rays_s: torch.Tensor, m: int,
                 box: torch.Tensor):
    """(T, Ct) f32 keys of a sorted (8, rp) stack: per m-lane tile and
    cluster the least world distance at which a lane of the tile can touch
    the cluster, 3e38 where none can (the exact keyed cull). `box` as in
    `cuda_jobs.worklists`."""
    if rays_s.device.type == "cpu":
        return keys_plain(spheres, rays_s, m, box)
    rp = check_sorted(rays_s, m)
    dev = rays_s.device
    ct = check_spheres(spheres, dev)
    kernels.check(box, "box", torch.float32, (6,), dev)
    keys = torch.empty((rp // m, ct), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        code = lib.wrt_cluster_cull_keyed(
            kernels.ptr(spheres), ct, kernels.ptr(rays_s), rp, m,
            kernels.ptr(box), T_MIN, kernels.ptr(keys), kernels.stream(dev))
    kernels.raise_on_error(code, "cluster_cull_keyed")
    kernels.launches["cluster_cull_keyed"] += 1
    return keys


def worklists_keyed(spheres: torch.Tensor, rays_s: torch.Tensor, m: int,
                    box: torch.Tensor, cull: str = "exact"):
    """(order (T, Ct) int32, keys (T, Ct) f32, counts (T,) int32) of a
    sorted (8, rp) stack: row t of `order` starts with its counts[t]
    surviving cluster ids near to far, `keys` holds their ascending keys
    (3e38 past the count). `cull` is "exact" (the keyed exact cull: the
    kernel on the card) or "cone"."""
    if cull == "cone":
        return cone_worklists_plain(spheres, rays_s, m, box)
    if cull != "exact":
        raise ValueError(f"cull {cull!r}: 'exact' or 'cone'")
    return sort_keyed(cluster_keys(spheres, rays_s, m, box))


def scan_sweep(tables: WorldTables, rays_s: torch.Tensor, perm, order, keys,
               counts, m: int, R: int, any_hit: bool, row_from_lane: int = 0,
               with_stats: bool = False):
    """The narrow phase over a sorted stack, outputs in the caller's order
    of R lanes: occlusion bool (R,) when any_hit, else (t (R,), idx (R,)
    int32, rows (SHADE_K, R - row_from_lane)). with_stats appends the
    (T, 4) int32 rows [entries scanned, entries processed, worklist
    length, (lane, cluster) pairs walked] per tile."""
    if rays_s.device.type == "cpu":
        plain = scan_shadow_plain if any_hit else scan_closest_plain
        *sorted_out, stats = plain(tables, rays_s, order, keys, counts, m,
                                   with_stats=True)
        out = [unpermute(x, perm, R) for x in sorted_out]
        if not any_hit:
            out.append(rows_plain(tables.shade_table,
                                  out[1][row_from_lane:]))
    else:
        rp = check_sorted(rays_s, m)
        dev = rays_s.device
        tw, ct = check_tables(tables, dev)
        n_tiles = rp // m
        kernels.check(perm, "perm", torch.int32, (rp,), dev)
        kernels.check(order, "order", torch.int32, (n_tiles, ct), dev)
        kernels.check(keys, "keys", torch.float32, (n_tiles, ct), dev)
        kernels.check(counts, "counts", torch.int32, (n_tiles,), dev)
        if not 0 <= R <= rp or not 0 <= row_from_lane <= R:
            raise ValueError(f"R {R} / row_from_lane {row_from_lane} "
                             f"outside [0, {rp}]")
        t = idx = rows = occ = stats = None
        if any_hit:
            occ = torch.empty(R, dtype=torch.bool, device=dev)
        else:
            t = torch.empty(R, dtype=torch.float32, device=dev)
            idx = torch.empty(R, dtype=torch.int32, device=dev)
            rows = torch.empty((SHADE_K, R - row_from_lane),
                               dtype=torch.float32, device=dev)
        if with_stats:
            stats = torch.empty((n_tiles, 4), dtype=torch.int32, device=dev)
        lib = kernels.library()
        with torch.cuda.device(dev):
            code = lib.wrt_scan_sweep(
                kernels.ptr(tables.features), tw, tables.valid_count,
                kernels.ptr(tables.shade_table), kernels.ptr(rays_s), rp, m,
                kernels.ptr(perm), R, kernels.ptr(order), kernels.ptr(keys),
                kernels.ptr(counts), kernels.ptr(tables.spheres), ct, T_MIN,
                A_LO_SCALE, HI_NUDGE, int(any_hit), row_from_lane,
                kernels.ptr(t), kernels.ptr(idx), kernels.ptr(rows),
                kernels.ptr(occ), kernels.ptr(stats), kernels.stream(dev))
        kernels.raise_on_error(code, "scan_sweep")
        kernels.launches["scan_sweep"] += 1
        out = [occ] if any_hit else [t, idx, rows]
    if with_stats:
        return (*out, stats)
    return out[0] if any_hit else tuple(out)


def _sort_and_cull(tables: WorldTables, rays8: torch.Tensor, seg_start: int,
                   m: int, cull: str):
    """Steps 1 and 2: (sorted stack, perm, order, keys, counts)."""
    if rays8.device.type != "cpu":
        kernels.check(rays8, "rays8", torch.float32)
    if rays8.dim() != 2 or rays8.shape[0] != 8:
        raise ValueError(f"rays8: shape {tuple(rays8.shape)}, expected (8, R)")
    rays_s, perm = coherence_sort(rays8, tables.box, m, seg_start)
    return (rays_s, perm, *worklists_keyed(tables.spheres, rays_s, m,
                                           tables.box, cull))


def closest_with_row(tables: WorldTables, rays8: torch.Tensor,
                     row_from_lane: int = 0, m: int = M_TILE2,
                     cull: str = "exact", with_stats: bool = False):
    """Closest hit plus winner rows of a multi-tile scene: (t (R,), idx (R,)
    int32, rows (SHADE_K, R - row_from_lane)), then the stats rows when
    with_stats. The lanes from row_from_lane on are sorted apart from the
    ones before when it is a multiple of the tile size (the fused sweep's
    shadow | extension split), as in the JAX package."""
    seg = row_from_lane if row_from_lane % m == 0 else 0
    rays_s, perm, order, keys, counts = _sort_and_cull(tables, rays8, seg, m,
                                                       cull)
    return scan_sweep(tables, rays_s, perm, order, keys, counts, m,
                      rays8.shape[-1], False, row_from_lane, with_stats)


def shadow(tables: WorldTables, rays8: torch.Tensor, m: int = M_TILE2,
           cull: str = "exact", with_stats: bool = False):
    """Any-hit occlusion of a multi-tile scene: bool (R,)."""
    rays_s, perm, order, keys, counts = _sort_and_cull(tables, rays8, 0, m,
                                                       cull)
    return scan_sweep(tables, rays_s, perm, order, keys, counts, m,
                      rays8.shape[-1], True, with_stats=with_stats)
