"""The job-stream path of multi-tile scenes: coherence sort, exact cull,
job-stream narrow phase; the CUDA kernels on the card, their plain
versions on the CPU.

The port of the JAX package's `ops/pallas_dense.py::_run3`, which serves
every scene of more than one 128-triangle tile there (`_run` dispatches to
it; `ops/cuda_dense.py` does the same here):

1. `ops/coherence.coherence_sort` pads the (8, R) ray stack to a multiple
   of g = `tune.M_TILE3` lanes and sorts the lanes (plain PyTorch on both
   devices);
2. the cull gives each g-lane group its worklist of tiles:
   `csrc/cluster_cull.cu` (`cluster_cull`), or `ops/cluster_cull.
   worklists_plain` on the CPU. It replaces XLA in the JAX package
   (`ops/cluster_cull.py::tile_cluster_worklist_exact`);
3. the narrow phase sweeps each group's worklist: `csrc/job_sweep.cu`
   (`job_sweep`, replacing `_kernel3`: per tile the lanes whose segment
   touches it queue up and one warp walks the tile for one lane; a
   worklist longer than `tune.JOB_CHUNK` entries is walked in chunks by
   several blocks and merged by the tie rule), or
   `ops/dense.jobs_closest_plain` / `jobs_shadow_plain` on the CPU;
4. outputs come back in the caller's lane order: the kernel writes them
   there through the permutation, the plain path scatters them.

Counts and worklists stay on the device and the grids are fixed by R and
the card, so a sweep makes no host sync and one launch of each kernel (the
job sweep's scratch is zeroed in part by one memset ahead of it). For CUDA
tensors the wrappers launch the kernels or raise: there is no fallback,
neither to the plain versions nor to `dense_sweep.cu`'s walk over every
tile.
"""

from __future__ import annotations

import torch

from .. import kernels
from .cluster_cull import A_LO_SCALE, HI_NUDGE, worklists_plain
from .coherence import coherence_sort
from .dense import (TRI_CHUNK, T_MIN, jobs_closest_plain, jobs_shadow_plain,
                    jobs_stats_plain, rows_plain)
from . import tune
from .tune import M_TILE3
from ..render.worldtris import FEAT_K, SHADE_K, WorldTables


def check_sorted(rays_s: torch.Tensor, g: int):
    kernels.check(rays_s, "rays_s", torch.float32)
    if rays_s.dim() != 2 or rays_s.shape[0] != 8 or rays_s.shape[1] % g:
        raise ValueError(f"rays_s: shape {tuple(rays_s.shape)}, expected "
                         f"(8, G * {g})")
    if not (g % 32 == 0 and 32 <= g <= 1024):
        raise ValueError(f"g {g}: a multiple of 32 in [32, 1024]")
    return rays_s.shape[1]


def check_spheres(spheres: torch.Tensor, dev) -> int:
    kernels.check(spheres, "spheres", torch.float32, device=dev)
    if spheres.dim() != 2 or spheres.shape[1] != 4 or spheres.shape[0] < 1:
        raise ValueError(f"spheres: shape {tuple(spheres.shape)}, expected "
                         "(n_tiles, 4)")
    if spheres.data_ptr() % 16:
        raise ValueError("spheres: rows must be 16-byte aligned")
    return spheres.shape[0]


def check_tables(tables: WorldTables, dev) -> tuple[int, int]:
    """Raise unless the tables fit the narrow-phase kernels; returns (padded
    triangle count, tile count)."""
    tw = tables.features.shape[-1] // 5
    kernels.check(tables.features, "features", torch.float32,
                  (FEAT_K, 5 * tw), dev)
    kernels.check(tables.shade_table, "shade_table", torch.float32,
                  (tw, SHADE_K), dev)
    if tw % 4 or tables.features.data_ptr() % 16:
        raise ValueError("features: the tiles are staged as 16-byte copies, "
                         "so the storage must be 16-byte aligned and the "
                         f"padded triangle count ({tw}) a multiple of 4")
    ct = check_spheres(tables.spheres, dev)
    if ct != -(-tw // TRI_CHUNK):
        raise ValueError(f"spheres: {ct} tiles, the tables have "
                         f"{-(-tw // TRI_CHUNK)}")
    if not 0 <= tables.valid_count <= tw:
        raise ValueError(f"valid_count {tables.valid_count} outside "
                         f"[0, {tw}]")
    return tw, ct


def worklists(spheres: torch.Tensor, rays_s: torch.Tensor, g: int,
              box: torch.Tensor):
    """(order (G, Ct) int32, counts (G,) int32) of a sorted (8, rp) stack:
    row g of `order` starts with its counts[g] surviving tile ids in
    ascending order; on the card the entries past the count are not
    written. `box` is the spheres' `box6` (`WorldTables.box`)."""
    if rays_s.device.type == "cpu":
        return worklists_plain(spheres, rays_s, g, box)
    rp = check_sorted(rays_s, g)
    dev = rays_s.device
    ct = check_spheres(spheres, dev)
    kernels.check(box, "box", torch.float32, (6,), dev)
    order = torch.empty((rp // g, ct), dtype=torch.int32, device=dev)
    counts = torch.empty(rp // g, dtype=torch.int32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        code = lib.wrt_cluster_cull(
            kernels.ptr(spheres), ct, kernels.ptr(rays_s), rp, g,
            kernels.ptr(box), A_LO_SCALE, HI_NUDGE, kernels.ptr(order),
            kernels.ptr(counts), kernels.stream(dev))
    kernels.raise_on_error(code, "cluster_cull")
    kernels.launches["cluster_cull"] += 1
    return order, counts


def unpermute(x_s: torch.Tensor, perm: torch.Tensor, R: int):
    """Sorted lanes back to the caller's order, the padding dropped."""
    out = torch.empty_like(x_s)
    out[perm.long()] = x_s
    return out[:R]


def job_sweep(tables: WorldTables, rays_s: torch.Tensor, perm, order,
              counts, g: int, R: int, any_hit: bool, row_from_lane: int = 0,
              with_stats: bool = False):
    """The narrow phase over a sorted stack, outputs in the caller's order
    of R lanes: occlusion bool (R,) when any_hit, else (t (R,), idx (R,)
    int32, rows (SHADE_K, R - row_from_lane)). with_stats appends the
    (G, 4) int32 rows [tiles walked, (lane, tile) pairs walked, worklist
    length, chunks it was walked in] per group. On the CPU the stats are
    those of one walk per group (`jobs_stats_plain`); on the card a split
    group's chunks prune one another as they finish, so its counts depend
    on timing."""
    if rays_s.device.type == "cpu":
        if any_hit:
            occ = jobs_shadow_plain(tables, rays_s, order, counts, g)
            out = [unpermute(occ, perm, R)]
        else:
            t_s, i_s = jobs_closest_plain(tables, rays_s, order, counts, g)
            idx = unpermute(i_s, perm, R)
            out = [unpermute(t_s, perm, R), idx,
                   rows_plain(tables.shade_table, idx[row_from_lane:])]
        if with_stats:
            out.append(jobs_stats_plain(tables, rays_s, order, counts, g,
                                        any_hit, tune.JOB_CHUNK))
        return out[0] if len(out) == 1 else tuple(out)
    rp = check_sorted(rays_s, g)
    dev = rays_s.device
    tw, ct = check_tables(tables, dev)
    kernels.check(perm, "perm", torch.int32, (rp,), dev)
    kernels.check(order, "order", torch.int32, (rp // g, ct), dev)
    kernels.check(counts, "counts", torch.int32, (rp // g,), dev)
    if not 0 <= R <= rp or not 0 <= row_from_lane <= R:
        raise ValueError(f"R {R} / row_from_lane {row_from_lane} outside "
                         f"[0, {rp}]")
    t = idx = rows = occ = stats = None
    if any_hit:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
    else:
        t = torch.empty(R, dtype=torch.float32, device=dev)
        idx = torch.empty(R, dtype=torch.int32, device=dev)
        rows = torch.empty((SHADE_K, R - row_from_lane), dtype=torch.float32,
                           device=dev)
    if with_stats:
        stats = torch.empty((rp // g, 4), dtype=torch.int32, device=dev)
    lib = kernels.library()
    chunk = tune.JOB_CHUNK
    scratch = torch.empty(lib.wrt_job_sweep_scratch_bytes(rp, g, ct, chunk),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.wrt_job_sweep(
            kernels.ptr(tables.features), tw, tables.valid_count,
            kernels.ptr(tables.shade_table), kernels.ptr(rays_s), rp, g,
            kernels.ptr(perm), R, kernels.ptr(order), kernels.ptr(counts),
            kernels.ptr(tables.spheres), ct, T_MIN, A_LO_SCALE, HI_NUDGE,
            int(any_hit), row_from_lane, kernels.ptr(t),
            kernels.ptr(idx), kernels.ptr(rows), kernels.ptr(occ),
            kernels.ptr(stats), chunk, kernels.ptr(scratch),
            kernels.stream(dev))
    kernels.raise_on_error(code, "job_sweep")
    kernels.launches["job_sweep"] += 1
    out = [occ] if any_hit else [t, idx, rows]
    if with_stats:
        out.append(stats)
    return out[0] if len(out) == 1 else tuple(out)


def _sort_and_cull(tables: WorldTables, rays8: torch.Tensor, seg_start: int):
    """Steps 1 and 2: (sorted stack, perm, order, counts)."""
    if rays8.device.type != "cpu":
        kernels.check(rays8, "rays8", torch.float32)
    if rays8.dim() != 2 or rays8.shape[0] != 8:
        raise ValueError(f"rays8: shape {tuple(rays8.shape)}, expected (8, R)")
    rays_s, perm = coherence_sort(rays8, tables.box, M_TILE3, seg_start)
    order, counts = worklists(tables.spheres, rays_s, M_TILE3, tables.box)
    return rays_s, perm, order, counts


def closest_with_row(tables: WorldTables, rays8: torch.Tensor,
                     row_from_lane: int = 0):
    """Closest hit plus winner rows of a multi-tile scene: (t (R,), idx (R,)
    int32, rows (SHADE_K, R - row_from_lane)). The lanes from
    row_from_lane on are sorted apart from the ones before when it is a
    multiple of the group size (the fused sweep's shadow | extension
    split), as in the JAX package."""
    R = rays8.shape[-1]
    seg = row_from_lane if row_from_lane % M_TILE3 == 0 else 0
    rays_s, perm, order, counts = _sort_and_cull(tables, rays8, seg)
    return job_sweep(tables, rays_s, perm, order, counts, M_TILE3, R, False,
                     row_from_lane)


def shadow(tables: WorldTables, rays8: torch.Tensor):
    """Any-hit occlusion of a multi-tile scene: bool (R,)."""
    rays_s, perm, order, counts = _sort_and_cull(tables, rays8, 0)
    return job_sweep(tables, rays_s, perm, order, counts, M_TILE3,
                     rays8.shape[-1], True)
