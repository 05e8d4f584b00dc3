"""Plain dense rays x world-triangles sweep (PyTorch).

The port's counterpart of the JAX package's `ops/dense.py`, and the plain
version of the CUDA sweep kernel (`ops/cuda_dense.py`). Rays arrive as the
(8, R) stack [dx, dy, dz, ox, oy, oz, t_max, pad] of the TPU kernel
(`ops/pallas_dense.py:_run`); a lane with t_max <= 0 is inactive.

Per triangle, with the Plucker ray feature [d, m = o x d, o, 1]:
    s_k = f_k . [d, m] (k = 0, 1, 2),  tn = f . [o, 1],  td = f . d
read from the f32 `features` table. td is the table's fifth column group,
as in the CPU reference, not the TPU kernel's s0 + s1 + s2. A triangle is
hit when all three s_k agree in sign (inclusive), |td| >= 1e-6 and
t = tn / td lies strictly inside (T_MIN, t_max). Closest mode keeps the
least t; on exact ties the lowest index wins. Every dot product is summed
left to right in separately rounded f32 operations, which the CUDA kernel
reproduces exactly, so kernel and plain version agree bit for bit.

Chunked over 128-triangle tiles, so memory stays bounded at any triangle
count. `closest_plain` / `shadow_plain` walk every tile, as the CUDA
`dense_sweep.cu` does. `jobs_closest_plain` / `jobs_shadow_plain` are the
plain versions of the job-stream kernel (`csrc/job_sweep.cu`): over a
coherence-sorted ray stack, each g-lane group walks only the tiles on its
cull worklist (`ops/cluster_cull.py`), in ascending order, with the same
per-triangle arithmetic (`_chunk_t`). As the cull only drops tiles that
no lane of the group can hit inside its interval, they give the full
walk's t and idx bit for bit. (The kernel also skips, lane by lane, a
tile whose sphere the lane's segment cannot touch; that changes no
result, so the plain versions walk every worklisted tile.
`jobs_stats_plain` replays that skip to count what the kernel counts.)
`scan_closest_plain` / `scan_shadow_plain` are the plain versions of the
scan kernel (`csrc/scan_sweep.cu`): each m-lane tile walks its keyed
worklist near to far, stops at the first key beyond every lane's reach,
skips an entry that no lane's open interval touches, and commits ties to
the lowest triangle index, so they too give the full walk's t and idx bit
for bit, whatever the order of the worklist.
"""

from __future__ import annotations

import torch

from .v3 import V3

TRI_CHUNK = 128
T_MIN = 1e-3  # every sweep's near bound, as in the JAX package
T_MAX = 1e30


def ray_stack(ro: V3, rd: V3, t_max) -> torch.Tensor:
    """(8, R) ray stack [d, o, t_max, 0] from V3 origins and directions."""
    R = ro.x.shape[0]
    out = torch.empty((8, R), dtype=torch.float32, device=ro.x.device)
    for k, c in enumerate((rd.x, rd.y, rd.z, ro.x, ro.y, ro.z)):
        out[k] = c
    out[6] = t_max
    out[7] = 0.0
    return out


def _chunk_t(rays8, feats, c0: int, c1: int):
    """(R, c1 - c0) hit distances and hit masks for triangles [c0, c1)."""
    dx, dy, dz, ox, oy, oz = (rays8[k][:, None] for k in range(6))
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    f = feats[:, :, c0:c1]  # (FEAT_K, 5, C)

    def side(g):
        return (dx * f[0, g] + dy * f[1, g] + dz * f[2, g] + mx * f[3, g]
                + my * f[4, g] + mz * f[5, g])

    s0, s1, s2 = side(0), side(1), side(2)
    tn = ox * f[6, 3] + oy * f[7, 3] + oz * f[8, 3] + f[9, 3]
    td = dx * f[0, 4] + dy * f[1, 4] + dz * f[2, 4]
    inside = (torch.minimum(torch.minimum(s0, s1), s2) >= 0.0) | (
        torch.maximum(torch.maximum(s0, s1), s2) <= 0.0)
    ok = inside & (torch.abs(td) >= 1e-6)
    t = tn / torch.where(ok, td, 1.0)
    return t, ok


def _chunks(tables):
    tw = tables.features.shape[1] // 5
    feats = tables.features.view(-1, 5, tw)
    for c0 in range(0, tables.valid_count, TRI_CHUNK):
        yield feats, c0, min(c0 + TRI_CHUNK, tables.valid_count)


def closest_plain(tables, rays8: torch.Tensor):
    """Closest hit: (t (R,) f32, idx (R,) int32, -1 on miss). A miss keeps
    t = t_max."""
    t_max = rays8[6]
    best_t = t_max.clone()
    best_i = torch.full_like(t_max, -1, dtype=torch.int32)
    for feats, c0, c1 in _chunks(tables):
        t, ok = _chunk_t(rays8, feats, c0, c1)
        ok = ok & (t > T_MIN) & (t < t_max[:, None])
        tm = torch.where(ok, t, float("inf"))
        cmin, carg = torch.min(tm, dim=1)  # first minimum on ties
        upd = cmin < best_t
        best_t = torch.where(upd, cmin, best_t)
        best_i = torch.where(upd, (carg + c0).to(torch.int32), best_i)
    return best_t, best_i


def shadow_plain(tables, rays8: torch.Tensor):
    """Any-hit occlusion: bool (R,)."""
    t_max = rays8[6]
    occ = torch.zeros(t_max.shape, dtype=torch.bool, device=t_max.device)
    for feats, c0, c1 in _chunks(tables):
        t, ok = _chunk_t(rays8, feats, c0, c1)
        occ = occ | (ok & (t > T_MIN) & (t < t_max[:, None])).any(dim=1)
    return occ


def worklist_mask(order: torch.Tensor, counts: torch.Tensor,
                  n_clusters: int) -> torch.Tensor:
    """(G, Ct) bool: cluster c is on group g's worklist (entries past the
    count are ignored, whatever they hold)."""
    G = order.shape[0]
    pos = torch.arange(order.shape[1], device=order.device)[None, :]
    ids = torch.where(pos < counts[:, None], order.long(), n_clusters)
    mask = torch.zeros((G, n_clusters + 1), dtype=torch.bool,
                       device=order.device)
    mask.scatter_(1, ids, True)
    return mask[:, :n_clusters]


def _job_tiles(tables, order, counts, g: int):
    """(feats, c0, c1, lanes) per tile on some group's worklist, in
    ascending tile order: lanes are the sorted lanes of the groups whose
    worklist holds tile [c0, c1)."""
    tw = tables.features.shape[1] // 5
    feats = tables.features.view(-1, 5, tw)
    n_tiles = -(-tw // TRI_CHUNK)
    mask = worklist_mask(order, counts, n_tiles)
    lane_in_group = torch.arange(g, device=order.device)
    for c in torch.nonzero(mask.any(0)).flatten().tolist():
        c0 = c * TRI_CHUNK
        c1 = min(c0 + TRI_CHUNK, tables.valid_count)
        if c1 <= c0:
            continue
        groups = torch.nonzero(mask[:, c]).flatten()
        yield feats, c0, c1, (groups[:, None] * g + lane_in_group).flatten()


def jobs_closest_plain(tables, rays_s: torch.Tensor, order, counts, g: int):
    """Closest hit of a sorted (8, rp) stack over each group's worklisted
    tiles: (t (rp,), idx (rp,) int32) in sorted lane order."""
    best_t = rays_s[6].clone()
    best_i = torch.full_like(best_t, -1, dtype=torch.int32)
    for feats, c0, c1, lanes in _job_tiles(tables, order, counts, g):
        rays = rays_s[:, lanes]
        t, ok = _chunk_t(rays, feats, c0, c1)
        ok = ok & (t > T_MIN) & (t < rays[6][:, None])
        cmin, carg = torch.min(torch.where(ok, t, float("inf")), dim=1)
        cur_t, cur_i = best_t[lanes], best_i[lanes]
        upd = cmin < cur_t
        best_t[lanes] = torch.where(upd, cmin, cur_t)
        best_i[lanes] = torch.where(upd, (carg + c0).to(torch.int32), cur_i)
    return best_t, best_i


def jobs_shadow_plain(tables, rays_s: torch.Tensor, order, counts, g: int):
    """Any-hit occlusion of a sorted (8, rp) stack over each group's
    worklisted tiles: bool (rp,) in sorted lane order."""
    occ = torch.zeros(rays_s.shape[1], dtype=torch.bool,
                      device=rays_s.device)
    for feats, c0, c1, lanes in _job_tiles(tables, order, counts, g):
        rays = rays_s[:, lanes]
        t, ok = _chunk_t(rays, feats, c0, c1)
        hit = (ok & (t > T_MIN) & (t < rays[6][:, None])).any(dim=1)
        occ[lanes] = occ[lanes] | hit
    return occ


def jobs_stats_plain(tables, rays_s: torch.Tensor, order, counts, g: int,
                     any_hit: bool):
    """What `csrc/job_sweep.cu` counts per group, (G, 3) int32 [tiles
    walked, (lane, tile) pairs walked, worklist length]: a lane is walked
    against a tile when its open interval (up to its best hit so far; up
    to t_max until occluded in any-hit mode) touches the tile's sphere, a
    tile when some lane is. That is the scan's walk over the job worklist
    with every key 0, where the early exit fires exactly when no lane is
    open, as the kernel's does."""
    keys = torch.zeros(order.shape, dtype=torch.float32, device=order.device)
    stats = _scan_plain(tables, rays_s, order, keys, counts, g, any_hit)[3]
    return stats[:, [1, 3, 2]]


def _scan_plain(tables, rays_s, order, keys, counts, m: int, any_hit: bool):
    """The scan narrow phase over a sorted (8, rp) stack, tile by tile:
    (best_t, best_i, occ, stats), stats (T, 4) int32 [entries scanned,
    entries processed, worklist length, (lane, cluster) pairs walked] per
    tile: a pair is walked when the lane's open interval touches the
    cluster's sphere."""
    # cluster_cull imports this module's T_MIN, so it is imported here.
    from .cluster_cull import HI_NUDGE, pair_ok, reach_terms

    tw = tables.features.shape[1] // 5
    feats = tables.features.view(-1, 5, tw)
    spheres = tables.spheres
    rp = rays_s.shape[1]
    t_max = rays_s[6]
    best_t = t_max.clone()
    best_i = torch.full_like(t_max, -1, dtype=torch.int32)
    occ = torch.zeros(rp, dtype=torch.bool, device=rays_s.device)
    d = rays_s[0:3]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    dlen, wcap = reach_terms(rays_s, spheres)
    stats = torch.zeros((rp // m, 4), dtype=torch.int32)
    stats[:, 2] = counts.cpu()
    for tile, count in enumerate(stats[:, 2].tolist()):
        lanes = slice(tile * m, (tile + 1) * m)
        rays = rays_s[:, lanes]
        for k in range(count):
            # A lane's open interval: up to its best hit so far; closed
            # once occluded in any-hit mode. Dead lanes have t_max 0.
            open_t = (torch.where(occ[lanes], 0.0, t_max[lanes]) if any_hit
                      else best_t[lanes])
            reach = torch.minimum(open_t * dlen[lanes], wcap[lanes])
            # Sorted early exit: no lane reaches this key, nor any later.
            if not bool(((open_t > 0.0)
                         & (keys[tile, k] <= reach * HI_NUDGE)).any()):
                break
            stats[tile, 0] += 1
            c = int(order[tile, k])
            touch = pair_ok(rays, dd[lanes], open_t, spheres[c:c + 1])[0]
            if not bool(touch.any()):
                continue
            stats[tile, 1] += 1
            stats[tile, 3] += int(touch.sum())
            c0 = c * TRI_CHUNK
            c1 = min(c0 + TRI_CHUNK, tables.valid_count)
            if c1 <= c0:
                continue
            t, ok = _chunk_t(rays, feats, c0, c1)
            ok = ok & touch[:, None] & (t > T_MIN) & (t < t_max[lanes, None])
            if any_hit:
                occ[lanes] |= ok.any(dim=1)
                continue
            cmin, carg = torch.min(torch.where(ok, t, float("inf")), dim=1)
            cidx = (carg + c0).to(torch.int32)
            cur_t, cur_i = best_t[lanes], best_i[lanes]
            upd = (cmin < cur_t) | ((cmin == cur_t) & (cidx < cur_i))
            best_t[lanes] = torch.where(upd, cmin, cur_t)
            best_i[lanes] = torch.where(upd, cidx, cur_i)
    return best_t, best_i, occ, stats


def scan_closest_plain(tables, rays_s: torch.Tensor, order, keys, counts,
                       m: int, with_stats: bool = False):
    """Closest hit of a sorted (8, rp) stack, each m-lane tile scanning its
    near-to-far worklist: (t (rp,), idx (rp,) int32) in sorted lane order;
    with_stats appends the (T, 4) int32 [scanned, processed, count, pairs
    walked] rows.
    On an exact-t tie the lowest triangle index wins."""
    t, idx, _, stats = _scan_plain(tables, rays_s, order, keys, counts, m,
                                   False)
    return (t, idx, stats) if with_stats else (t, idx)


def scan_shadow_plain(tables, rays_s: torch.Tensor, order, keys, counts,
                      m: int, with_stats: bool = False):
    """Any-hit occlusion of a sorted (8, rp) stack over each tile's
    near-to-far worklist: bool (rp,) in sorted lane order."""
    _, _, occ, stats = _scan_plain(tables, rays_s, order, keys, counts, m,
                                   True)
    return (occ, stats) if with_stats else occ


def rows_plain(shade_table: torch.Tensor, idx: torch.Tensor):
    """Winner shade rows, transposed: (SHADE_K, R), zeros where idx < 0."""
    rows = shade_table[idx.clamp(min=0).long()].T
    return torch.where((idx >= 0)[None, :], rows, 0.0).contiguous()
