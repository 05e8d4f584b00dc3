"""Exact per-group cluster worklists: the cull of the job-stream path.

The port of the JAX package's `ops/cluster_cull.py::
tile_cluster_worklist_exact` with `with_keys=False`, the branch that its
job-stream path (`_run3`) takes. Per lane of a coherence-sorted (8, rp)
ray stack:

- the scene-box slab exit caps the lane's interval: t_clip =
  min(t_max, max(t_exit, 0)), 0 for a dead lane (a direction component
  below 1e-20 in magnitude counts as +-1e-20);
- a cluster (a 128-triangle tile with bounding sphere [c, r]) survives
  when the lane's segment (T_MIN, t_clip) can touch the sphere. The test
  works in ray-parameter units through dd = |d|^2 (primary rays are not
  unit length) and is sqrt-free: with b = d . (o - c), cc = |o - c|^2 -
  r^2 and disc = b^2 - dd cc, it asks disc >= 0, (a_lo <= 0 or disc >=
  a_lo^2) and (b_hi >= 0 or disc >= b_hi^2), a_lo = dd T_MIN (1 - 1e-6)
  + b, b_hi = dd t_clip (1 + 1e-6) + b. The ends are nudged outward, so
  rounding can only admit a cluster, never drop one;
- a group's worklist is the OR over its g lanes, survivors first in
  ascending cluster id, with their count.

Every product and sum is a separately rounded f32 operation in the order
written, which the CUDA kernel (`csrc/cluster_cull.cu`, wrapper
`ops/cuda_jobs.py`) repeats, so the two give the same worklists. The plain
version here is chunked over clusters and lanes, so its memory stays
bounded at any size.

The cone cull `tile_cluster_worklist` (reached only through `cull_sub` or
`exact_cull=False` in the JAX package) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .coherence import scene_box
from .dense import T_MIN

# The interval nudges as f32, the values the JAX package computes with.
A_LO_SCALE = float(np.float32(T_MIN * (1.0 - 1e-6)))
HI_NUDGE = float(np.float32(1.0 + 1e-6))
CLUSTER_CHUNK = 128
LANE_CHUNK = 32768


def lane_terms(rays_s: torch.Tensor, spheres: torch.Tensor):
    """Per lane: (dd = |d|^2, t_clip), t_clip 0 for a dead lane."""
    d, o, t_max = rays_s[0:3], rays_s[3:6], rays_s[6]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    lo, hi = scene_box(spheres)
    t_exit = None
    for ax in range(3):
        d_safe = torch.where(torch.abs(d[ax]) > 1e-20, d[ax],
                             torch.where(d[ax] >= 0.0, 1e-20, -1e-20))
        t1 = (lo[ax] - o[ax]) / d_safe
        t2 = (hi[ax] - o[ax]) / d_safe
        far = torch.maximum(t1, t2)
        t_exit = far if t_exit is None else torch.minimum(t_exit, far)
    t_clip = torch.minimum(t_max, torch.clamp(t_exit, min=0.0))
    return dd, torch.where(t_max > 0.0, t_clip, 0.0)


def pair_ok(rays_s, dd, t_clip, sph):
    """(C, L) bool: lane l's segment can touch sphere c."""
    cx, cy, cz, r = (sph[:, k:k + 1] for k in range(4))
    ocx = rays_s[3][None] - cx
    ocy = rays_s[4][None] - cy
    ocz = rays_s[5][None] - cz
    b = rays_s[0][None] * ocx + rays_s[1][None] * ocy + rays_s[2][None] * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - dd[None] * cc
    a_lo = dd[None] * A_LO_SCALE + b
    b_hi = dd[None] * (t_clip * HI_NUDGE)[None] + b
    return ((disc >= 0.0) & (t_clip[None] > 0.0) & (r >= 0.0)
            & ((a_lo <= 0.0) | (disc >= a_lo * a_lo))
            & ((b_hi >= 0.0) | (disc >= b_hi * b_hi)))


def worklists_plain(spheres: torch.Tensor, rays_s: torch.Tensor, g: int):
    """(order (G, Ct) int32, counts (G,) int32) of a sorted (8, rp) stack,
    rp a multiple of g. Row g of `order` holds its `counts[g]` survivors in
    ascending id, then the other clusters in ascending id."""
    rp = rays_s.shape[1]
    G = rp // g
    ct = spheres.shape[0]
    dev = rays_s.device
    dd, t_clip = lane_terms(rays_s, spheres)
    possible = torch.zeros((G, ct), dtype=torch.bool, device=dev)
    step = g * max(1, LANE_CHUNK // g)
    for l0 in range(0, rp, step):
        l1 = min(l0 + step, rp)
        lanes = slice(l0, l1)
        for c0 in range(0, ct, CLUSTER_CHUNK):
            c1 = min(c0 + CLUSTER_CHUNK, ct)
            ok = pair_ok(rays_s[:, lanes], dd[lanes], t_clip[lanes],
                         spheres[c0:c1])
            possible[l0 // g:l1 // g, c0:c1] = \
                ok.view(c1 - c0, (l1 - l0) // g, g).any(2).T
    counts = possible.sum(1, dtype=torch.int32)
    ids = torch.arange(ct, dtype=torch.int32, device=dev)
    key = torch.where(possible, ids[None, :], ct)
    order = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    return order, counts

