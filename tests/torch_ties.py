"""Exact-t ties across tiles for the narrow-phase tests, on either device.

No JAX here: the card tests (`tests/test_torch_cuda.py`) use it too.
"""

import torch

from webgpu_raytracer_tpu_torch.ops.coherence import box6
from webgpu_raytracer_tpu_torch.ops.dense import TRI_CHUNK


def copy_triangle(tables, src: int, dst: int):
    """`tables` with triangle dst made a copy of triangle src (features and
    shade row), so a lane that hits one hits the other at the same t, bit
    for bit. dst's tile sphere grows to hold src's tile sphere too (a
    larger bound only admits more), and the box is taken again."""
    tw = tables.features.shape[1] // 5
    feats = tables.features.clone().view(-1, 5, tw)
    feats[:, :, dst] = feats[:, :, src]
    shade = tables.shade_table.clone()
    shade[dst] = shade[src]
    spheres = tables.spheres.clone()
    a, b = spheres[dst // TRI_CHUNK], spheres[src // TRI_CHUNK]
    reach = torch.linalg.vector_norm(a[:3] - b[:3]) + b[3]
    spheres[dst // TRI_CHUNK, 3] = torch.maximum(a[3], reach) * 1.001
    return tables._replace(features=feats.view(-1, 5 * tw).contiguous(),
                           shade_table=shade, spheres=spheres,
                           box=box6(spheres))


def cross_tile_tie(tables, idx, home: int, away: int, move: bool):
    """A tie between tiles `home` and `away` over the triangle of tile
    `home` that most lanes of `idx` (a full sweep's winners) hit: it is
    copied over the least-hit triangle of tile `away`. With `move` it is
    moved there instead (copied, and its old features zeroed, which no ray
    hits), and that is copied back over the least-hit triangle of tile
    `home`: the original then lies in `away`, the copy in `home`. Returns
    (tables, original, copy)."""
    hits = torch.bincount(idx[idx >= 0].long(),
                          minlength=tables.valid_count).cpu()

    def pick(tile, most):
        lo = tile * TRI_CHUNK
        part = hits[lo:min(lo + TRI_CHUNK, tables.valid_count)]
        return lo + int(torch.argmax(part) if most else torch.argmin(part))

    src, there, back = pick(home, True), pick(away, False), pick(home, False)
    tied = copy_triangle(tables, src, there)
    if not move:
        return tied, src, there
    tw = tied.features.shape[1] // 5
    feats = tied.features.clone().view(-1, 5, tw)
    feats[:, :, src] = 0.0
    moved = tied._replace(features=feats.view(-1, 5 * tw))
    return copy_triangle(moved, there, back), there, back
