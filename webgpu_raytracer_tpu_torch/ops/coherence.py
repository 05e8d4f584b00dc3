"""Coherence sort of a ray stack, the first step of the job-stream path.

The port of the JAX package's `ops/pallas_dense.py::_coherence_sort`: pad
the (8, R) ray stack [d, o, t_max, pad] to a multiple of the group size g,
give every lane a key (direction bin, then origin cell), and sort the lanes
stably by it, so that each g-lane group shares a direction bin and an
origin cell and its cull worklist (`ops/cluster_cull.py`) stays short.

- Origin cells: `CELL_BITS` bits per axis over the live lanes' origin box
  (the JAX `key_mode="obox"`), the cell width floored at the scene extent
  / 2^CELL_FLOOR_BITS (a thin lens's origin noise collapses to one cell
  and the stable sort keeps raster order).
- Direction bins: `DIR_BITS` bits per normalised component.
- Dead lanes (t_max <= 0) and the padding go to the end of their segment:
  whole groups die, and the cull gives them no work.
- `seg_start` splits the lanes into two segments sorted apart, as the
  fused per-bounce sweep packs its shadow lanes first.

Cell and bin indices are clamped in float before the cast to int32, which
maps NaN and -inf to 0 on every device (float-to-int casts of values out of
range differ between the CPU and CUDA). The TPU-only bf16 split of the
sorted rays (`_split2`, `rayk3`) is not carried over. Plain PyTorch on both
devices: O(R) elementwise work and one library sort, as in the JAX
package, where it is XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .tune import CELL_BITS, CELL_FLOOR_BITS, DIR_BITS
from .v3 import sqrt_rn

BIG = 3e38  # the JAX package's +-3e38 sentinels of masked min / max


def scene_box(spheres: torch.Tensor):
    """(lo (3,), hi (3,)): the box of the live tile spheres (r >= 0)."""
    live = (spheres[:, 3] >= 0.0)[:, None]
    c, r = spheres[:, 0:3], spheres[:, 3:4]
    lo = torch.where(live, c - r, BIG).amin(0)
    hi = torch.where(live, c + r, -BIG).amax(0)
    return lo, hi


def box6(spheres: torch.Tensor) -> torch.Tensor:
    """`scene_box` as one (6,) tensor [lo, hi]: a property of the tables
    (`WorldTables.box`), computed once when they are built, so that no
    sweep reduces the spheres again. The sort and the culls take it as
    their `box`."""
    return torch.cat(scene_box(spheres))


def _bin(x: torch.Tensor, n: int) -> torch.Tensor:
    """clip(int(x), 0, n - 1), clamped in float first (NaN -> 0)."""
    x = torch.where(x > 0.0, x, 0.0)
    return torch.clamp(x, max=float(n - 1)).to(torch.int32)


def sort_key(rays8: torch.Tensor, box: torch.Tensor,
             seg_start: int) -> torch.Tensor:
    """The int32 sort key of every lane of a padded (8, rp) ray stack, the
    segment included. `box` is the tile spheres' `box6`."""
    rp = rays8.shape[1]
    dev = rays8.device
    d = rays8[0:3]
    o = rays8[3:6]
    t_max = rays8[6]
    lo, hi = box[0:3], box[3:6]
    sext = torch.clamp(hi - lo, min=1e-20)
    lane_live = t_max > 0.0
    cl = 1 << CELL_BITS
    lv = 1 << DIR_BITS
    dl = sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dn = d / torch.clamp(dl, min=1e-20)
    key = torch.zeros(rp, dtype=torch.int32, device=dev)
    dir_bin = torch.zeros(rp, dtype=torch.int32, device=dev)
    for a in range(3):
        o_lo = torch.where(lane_live, o[a], BIG).amin()
        o_ext = torch.clamp(
            torch.where(lane_live, o[a], -BIG).amax() - o_lo, min=1e-20)
        cell_w = torch.maximum(o_ext * (1.0 / cl),
                               sext[a] * (2.0 ** -CELL_FLOOR_BITS))
        key = key * cl + _bin((o[a] - o_lo) / cell_w, cl)
        dir_bin = dir_bin * lv + _bin((dn[a] + 1.0) * (0.5 * lv), lv)
    dir_span = 1 << (3 * DIR_BITS)
    cell_span = 1 << (3 * CELL_BITS)
    key = dir_bin * cell_span + key
    key = torch.where(lane_live, key, cell_span * dir_span)
    seg = (torch.arange(rp, device=dev) >= seg_start).to(torch.int32)
    return key + seg * (2 * cell_span * dir_span)


def coherence_sort(rays8: torch.Tensor, box: torch.Tensor, g: int,
                   seg_start: int = 0):
    """Pad (8, R) to (8, rp), rp a multiple of g, and sort the lanes.

    Returns (sorted (8, rp) ray stack, perm (rp,) int32): sorted lane l is
    lane perm[l] of the padded stack; perm[l] >= R marks padding."""
    R = rays8.shape[1]
    rp = -(-R // g) * g
    if rp != R:
        rays8 = F.pad(rays8, (0, rp - R))  # t_max 0: dead
    key = sort_key(rays8, box, seg_start)
    perm = torch.sort(key, stable=True).indices
    return rays8.index_select(1, perm), perm.to(torch.int32)
