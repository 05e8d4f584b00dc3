"""Per-group cluster worklists: the culls of the multi-tile paths.

The port of the JAX package's `ops/cluster_cull.py`. A cluster is a
128-triangle tile with its bounding sphere [c, r]; a group (a "tile" of the
scan path) is a run of lanes of a coherence-sorted (8, rp) ray stack. Per
lane, the scene-box slab exit caps the interval: t_clip = min(t_max,
max(t_exit, 0)), 0 for a dead lane (a direction component below 1e-20 in
magnitude counts as +-1e-20). All three culls work in ray-parameter units
through dd = |d|^2 (primary rays are not unit length), with b = d . (o -
c), cc = |o - c|^2 - r^2 and disc = b^2 - dd cc.

- `worklists_plain`: `tile_cluster_worklist_exact(with_keys=False)`, the
  cull of the job-stream path (`_run3`). A cluster survives when some
  lane's segment (T_MIN, t_clip) can touch its sphere. Sqrt-free: disc >=
  0, (a_lo <= 0 or disc >= a_lo^2) and (b_hi >= 0 or disc >= b_hi^2), a_lo
  = dd T_MIN (1 - 1e-6) + b, b_hi = dd t_clip (1 + 1e-6) + b. The ends are
  nudged outward, so rounding can only admit a cluster, never drop one.
  Survivors first in ascending cluster id, with their count.
- `worklists_keyed_plain`: the `with_keys=True` branch, the cull of the
  scan path (`_run2`). The same test in its sqrt form, not nudged: sq =
  sqrt(max(disc, 0)), disc >= 0, -b + sq >= dd T_MIN and -b - sq <= dd
  t_clip. Each survivor carries a key, the least distance in WORLD units
  at which any lane of the group can touch it, max((-b - sq) / dd * |d|,
  0) (3e38 for a dropped cluster), and survivors come sorted near to far,
  so the scan kernel can stop at the first key beyond every lane's reach.
- `cone_worklists_plain`: `tile_cluster_worklist`, the conservative cone
  cull that the scan path takes with `cull="cone"`: per `sub`-lane subtile
  an origin sphere and a direction cone (tested in the cosine domain),
  OR-reduced to the group, keys max(dist - (r + r_origins), 0). XLA in the
  JAX package and small (rp / sub x clusters pairs), so plain PyTorch on
  both devices is its port.

Every product, sum, root and quotient of the two exact culls is a
separately rounded f32 operation in the order written, which the CUDA
kernels (`csrc/cluster_cull.cu`, wrappers `ops/cuda_jobs.py` and
`ops/cuda_scan.py`) repeat, so kernel and plain version give the same
worklists. The plain versions are chunked over clusters and lanes, so their
memory stays bounded at any size.
"""

from __future__ import annotations

import numpy as np
import torch

from .coherence import BIG
from .dense import T_MIN
from .tune import SUBTILE
from .v3 import sqrt_rn

# The interval nudges as f32, the values the JAX package computes with.
A_LO_SCALE = float(np.float32(T_MIN * (1.0 - 1e-6)))
HI_NUDGE = float(np.float32(1.0 + 1e-6))
CLUSTER_CHUNK = 128
LANE_CHUNK = 32768


def box_interval(rays_s: torch.Tensor, box: torch.Tensor):
    """Per lane: (t_enter, t_exit) of the live spheres' box (`box`, their
    `coherence.box6`), by slabs."""
    d, o = rays_s[0:3], rays_s[3:6]
    lo, hi = box[0:3], box[3:6]
    t_enter = t_exit = None
    for ax in range(3):
        d_safe = torch.where(torch.abs(d[ax]) > 1e-20, d[ax],
                             torch.where(d[ax] >= 0.0, 1e-20, -1e-20))
        t1 = (lo[ax] - o[ax]) / d_safe
        t2 = (hi[ax] - o[ax]) / d_safe
        far = torch.maximum(t1, t2)
        near = torch.minimum(t1, t2)
        t_exit = far if t_exit is None else torch.minimum(t_exit, far)
        t_enter = near if t_enter is None else torch.maximum(t_enter, near)
    return t_enter, t_exit


def lane_terms(rays_s: torch.Tensor, box: torch.Tensor):
    """Per lane: (dd = |d|^2, t_clip), t_clip 0 for a dead lane."""
    d, t_max = rays_s[0:3], rays_s[6]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    _, t_exit = box_interval(rays_s, box)
    t_clip = torch.minimum(t_max, torch.clamp(t_exit, min=0.0))
    return dd, torch.where(t_max > 0.0, t_clip, 0.0)


def reach_terms(rays_s: torch.Tensor, box: torch.Tensor):
    """Per lane: (dlen = |d|, wcap), wcap the scene box's exit in world
    units, 0 for a lane that misses the box: what caps a lane's reach in
    the scan kernel's sorted early exit."""
    d = rays_s[0:3]
    dlen = sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    t_enter, t_exit = box_interval(rays_s, box)
    hit_box = (t_enter <= t_exit) & (t_exit > 0.0)
    return dlen, torch.where(hit_box, t_exit, 0.0) * dlen


def _pair_terms(rays_s, dd, sph):
    """(b, disc, r), each (C, L) or (C, 1), of lanes x spheres."""
    cx, cy, cz, r = (sph[:, k:k + 1] for k in range(4))
    ocx = rays_s[3][None] - cx
    ocy = rays_s[4][None] - cy
    ocz = rays_s[5][None] - cz
    b = rays_s[0][None] * ocx + rays_s[1][None] * ocy + rays_s[2][None] * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    return b, b * b - dd[None] * cc, r


def pair_ok(rays_s, dd, t_clip, sph):
    """(C, L) bool: lane l's segment can touch sphere c."""
    b, disc, r = _pair_terms(rays_s, dd, sph)
    a_lo = dd[None] * A_LO_SCALE + b
    b_hi = dd[None] * (t_clip * HI_NUDGE)[None] + b
    return ((disc >= 0.0) & (t_clip[None] > 0.0) & (r >= 0.0)
            & ((a_lo <= 0.0) | (disc >= a_lo * a_lo))
            & ((b_hi >= 0.0) | (disc >= b_hi * b_hi)))


def pair_keyed(rays_s, dd, dlen, t_clip, sph):
    """((C, L) bool, (C, L) f32): lane l's segment can touch sphere c (the
    sqrt form, not nudged), and the world distance at which it enters it
    (0 from inside)."""
    b, disc, r = _pair_terms(rays_s, dd, sph)
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    nb = -b
    ok = ((disc >= 0.0) & (t_clip[None] > 0.0) & (r >= 0.0)
          & (nb + sq >= dd[None] * T_MIN)
          & (nb - sq <= dd[None] * t_clip[None]))
    entry = torch.clamp((nb - sq) / dd[None] * dlen[None], min=0.0)
    return ok, entry


def _chunks(rp: int, ct: int, g: int):
    """(lane slice, l0, l1, c0, c1) blocks of whole groups x clusters."""
    step = g * max(1, LANE_CHUNK // g)
    for l0 in range(0, rp, step):
        l1 = min(l0 + step, rp)
        for c0 in range(0, ct, CLUSTER_CHUNK):
            yield slice(l0, l1), l0, l1, c0, min(c0 + CLUSTER_CHUNK, ct)


def worklists_plain(spheres: torch.Tensor, rays_s: torch.Tensor, g: int,
                    box: torch.Tensor):
    """(order (G, Ct) int32, counts (G,) int32) of a sorted (8, rp) stack,
    rp a multiple of g. Row g of `order` holds its `counts[g]` survivors in
    ascending id, then the other clusters in ascending id. `box` is the
    spheres' `coherence.box6`, here and below."""
    rp = rays_s.shape[1]
    G = rp // g
    ct = spheres.shape[0]
    dev = rays_s.device
    dd, t_clip = lane_terms(rays_s, box)
    possible = torch.zeros((G, ct), dtype=torch.bool, device=dev)
    for lanes, l0, l1, c0, c1 in _chunks(rp, ct, g):
        ok = pair_ok(rays_s[:, lanes], dd[lanes], t_clip[lanes],
                     spheres[c0:c1])
        possible[l0 // g:l1 // g, c0:c1] = \
            ok.view(c1 - c0, (l1 - l0) // g, g).any(2).T
    counts = possible.sum(1, dtype=torch.int32)
    ids = torch.arange(ct, dtype=torch.int32, device=dev)
    key = torch.where(possible, ids[None, :], ct)
    order = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    return order, counts


def sort_keyed(keys: torch.Tensor):
    """Near-to-far worklists from a (T, Ct) key map that holds 3e38 for a
    dropped cluster: (order (T, Ct) int32, sorted keys (T, Ct), counts
    (T,) int32). Equal keys keep ascending cluster id."""
    counts = (keys < BIG).sum(1, dtype=torch.int32)
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    return order.to(torch.int32), keys_s, counts


def keys_plain(spheres: torch.Tensor, rays_s: torch.Tensor, m: int,
               box: torch.Tensor):
    """(T, Ct) f32: per m-lane tile of a sorted (8, rp) stack and cluster,
    the least world distance at which a lane of the tile can touch the
    cluster, 3e38 where none can."""
    rp = rays_s.shape[1]
    ct = spheres.shape[0]
    dd, t_clip = lane_terms(rays_s, box)
    dlen = sqrt_rn(dd)
    keys = torch.empty((rp // m, ct), dtype=torch.float32,
                       device=rays_s.device)
    for lanes, l0, l1, c0, c1 in _chunks(rp, ct, m):
        ok, entry = pair_keyed(rays_s[:, lanes], dd[lanes], dlen[lanes],
                               t_clip[lanes], spheres[c0:c1])
        key = torch.where(ok, entry, BIG)
        keys[l0 // m:l1 // m, c0:c1] = \
            key.view(c1 - c0, (l1 - l0) // m, m).amin(2).T
    return keys


def worklists_keyed_plain(spheres: torch.Tensor, rays_s: torch.Tensor,
                          m: int, box: torch.Tensor):
    """(order (T, Ct) int32, keys (T, Ct) f32, counts (T,) int32) of a
    sorted (8, rp) stack, rp a multiple of m: row t of `order` holds its
    counts[t] survivors near to far, `keys` their ascending keys (3e38 past
    the count)."""
    return sort_keyed(keys_plain(spheres, rays_s, m, box))


CONE_CHUNK = 2048  # subtiles per block of the cone cull's pair map


def cone_worklists_plain(spheres: torch.Tensor, rays_s: torch.Tensor, m: int,
                         box: torch.Tensor, sub: int = SUBTILE):
    """The cone cull: the return contract of `worklists_keyed_plain`, from a
    bounding sphere of the origins and a bounding cone of the directions of
    every `sub`-lane subtile, OR-reduced to the m-lane tile. Conservative:
    its survivors hold the exact cull's."""
    rp = rays_s.shape[1]
    if m % sub:
        sub = m
    group = m // sub
    t = rp // sub
    d = rays_s[0:3].view(3, t, sub)
    o = rays_s[3:6].view(3, t, sub)
    t_max = rays_s[6].view(t, sub)
    act = t_max > 0.0
    n_act = torch.clamp(act.sum(1), min=1)

    # Origin bounding sphere per subtile (masked mean, max radius).
    co = torch.where(act[None], o, 0.0).sum(2) / n_act[None]      # (3, t)
    dist_o = sqrt_rn(((o - co[:, :, None]) ** 2).sum(0))
    r_o = torch.where(act, dist_o, 0.0).amax(1)                   # (t,)

    # Direction bounding cone per subtile.
    dlen = sqrt_rn((d * d).sum(0))                                # (t, sub)
    dn = d / torch.clamp(dlen, min=1e-20)[None]
    a = torch.where(act[None], dn, 0.0).sum(2)
    a = a / torch.clamp(sqrt_rn((a * a).sum(0, keepdim=True)), min=1e-20)
    cos_t = torch.where(act, (a[:, :, None] * dn).sum(0), 1.0).amin(1)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = sqrt_rn(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    tile_live = act.any(1)

    # Each lane's reach in world units, capped by its exit of the scene box.
    dlen_l, wcap = reach_terms(rays_s, box)
    reach = torch.minimum(rays_s[6] * dlen_l, wcap).view(t, sub)
    tmax_tile = torch.where(act, reach, 0.0).amax(1)

    cc = spheres[:, 0:3]
    rc = spheres[:, 3]
    ct = spheres.shape[0]
    keys = torch.empty((rp // m, ct), dtype=torch.float32,
                       device=rays_s.device)
    step = group * max(1, CONE_CHUNK // group)
    for s0 in range(0, t, step):
        s = slice(s0, min(s0 + step, t))
        rcp = rc[None, :] + r_o[s, None]                          # (S, Ct)
        v = cc[None] - co.T[s, None, :]                           # (S, Ct, 3)
        dist = sqrt_rn((v * v).sum(-1))
        inside = dist <= rcp
        cos_av = (a.T[s, None, :] * v).sum(-1) / torch.clamp(dist, min=1e-20)
        # alpha - beta <= theta in the cosine domain (alpha the angle from
        # the axis to the cluster, beta its angular radius, theta the cone's
        # half-angle): theta + beta >= pi, or cos(alpha) >= cos(theta +
        # beta).
        sin_b = torch.clamp(rcp / torch.clamp(dist, min=1e-20), 0.0, 1.0)
        cos_b = sqrt_rn(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
        cos_sum = cos_b * cos_t[s, None] - sin_b * sin_t[s, None]
        hit_cone = (cos_t[s, None] <= -cos_b) | (
            torch.clamp(cos_av, -1.0, 1.0) >= cos_sum - 1e-6)
        reachable = (dist - rcp) <= tmax_tile[s, None]
        possible = ((inside | hit_cone) & reachable & tile_live[s, None]
                    & (rc >= 0.0)[None, :])
        key = torch.where(possible, torch.clamp(dist - rcp, min=0.0), BIG)
        keys[s0 // group:s.stop // group] = \
            key.view(-1, group, ct).amin(1)
    return sort_keyed(keys)
