"""Path tracing over the dense world-triangle sweep: the port's main path.

The port of the JAX package's `ops/dense_trace.py` row-state path:
`trace_pixels_dense` (unbanded, whole image, with the thin-lens ray
generation of `_trace_lanes`) and `ray_color_dense_rows`, the bounce loop
with one shade launch and one fused 2R-lane sweep a bounce. Same estimator
and the same RNG streams as the JAX package's default `ray_color_dense`.

Differences of mechanism, not of result:
- every one of `max_depth` bounces runs; there is no host sync for JAX's
  `lax.cond(any_live)` skip. A bounce over all-dead lanes only resolves
  the pending NEE and adds zero;
- the exact ray count is reduced on the device, with no per-bounce sync;
- the band and tail-compaction knobs of the TPU path are not ported, nor
  the row and sample offsets that the JAX package's sharded renders pass.
"""

from __future__ import annotations

import torch

from . import bsdf_v3 as bsdf
from .cuda_dense import closest_with_row
from .dense import T_MAX, ray_stack
from .rng import init_rng, rand_n
from .shade_rows import shade
from .v3 import V3
from ..render.worldtris import WorldTables


def ray_color_dense_rows(tables: WorldTables, ro: V3, rd: V3,
                         rng: torch.Tensor, max_depth: int):
    """Returns (radiance V3, rng, rays): `rays` is a float64 device scalar,
    the EXACT count of rays traced: the R primaries plus, per bounce, the
    NEE shadow lanes and the extension lanes actually swept."""
    R = ro.x.shape[0]
    dev = ro.x.device
    f32 = torch.float32
    _, idx, rowT = closest_with_row(tables, ray_stack(ro, rd, T_MAX))
    zeros = torch.zeros(R, dtype=f32, device=dev)
    ones = torch.ones(R, dtype=f32, device=dev)
    state = torch.stack([
        ones,                                   # 0  active
        ro.x, ro.y, ro.z, rd.x, rd.y, rd.z,     # 1-6 ray
        ones, ones, ones,                       # 7-9 throughput
        zeros, zeros, zeros,                    # 10-12 radiance
        zeros,                                  # 13 prev_pdf
        ones,                                   # 14 specular_bounce
        zeros,                                  # 15 nee_prev
        zeros, zeros, zeros,                    # 16-18 pending_nee
        ones,                                   # 19 occluded_prev
    ])
    rays = torch.full((), float(R), dtype=torch.float64, device=dev)

    for depth in range(max_depth):
        out, rng, rays8 = shade(state, rng, rowT, idx, tables.light_rows,
                                depth, tables.light_count, max_depth)
        _, idx2, rowT = closest_with_row(tables, rays8, row_from_lane=R)
        rays = rays + out[15].sum(dtype=torch.float64) \
            + out[26].sum(dtype=torch.float64)
        # Rows 19-26 (the rays just swept) are spent: row 19 becomes the
        # next bounce's occluded_prev in place, and rows 0-19 its state.
        out[19] = (idx2[:R] >= 0).to(f32)
        state = out[:20]
        idx = idx2[R:]

    take = (state[15] > 0.5) & ~(state[19] > 0.5)
    g = torch.where(take, 1.0, 0.0)
    radiance = V3(state[10] + state[16] * g, state[11] + state[17] * g,
                  state[12] + state[18] * g)
    return radiance, rng, rays


def trace_pixels_dense(tables: WorldTables, camera24: torch.Tensor,
                       frame_count: int, jitter: torch.Tensor, width: int,
                       height: int, spp: int, max_depth: int,
                       with_stats: bool = False):
    """One progressive frame over the whole image: thin-lens primaries
    (the JAX package's `_trace_lanes`) traced by `ray_color_dense_rows`.

    camera24 (24,) f32 and jitter (2,) f32 live on the tables' device.
    Per-pixel RNG streams depend only on (pixel, frame, sample), as in the
    JAX package. Returns (H*W, 3) radiance averaged over spp; with
    with_stats=True, (radiance, rays) with rays the exact float64 device
    count."""
    cam = camera24
    lens_radius = cam[3]
    p_idx = torch.arange(width * height, dtype=torch.int64,
                         device=tables.device)
    px = (p_idx % width).to(torch.float32)
    py = (p_idx // width).to(torch.float32)

    cx = cy = cz = 0.0
    rays = 0.0
    for i in range(spp):
        rng = init_rng(p_idx, frame_count * spp + i)
        rng, (dr1, dr2) = rand_n(rng, 2)
        dx, dy = bsdf.random_in_unit_disk(dr1, dr2)
        rdx = lens_radius * dx
        rdy = lens_radius * dy
        off = V3(cam[16] * rdx + cam[20] * rdy,
                 cam[17] * rdx + cam[21] * rdy,
                 cam[18] * rdx + cam[22] * rdy)

        u = (px + 0.5 + jitter[0] * width) / width
        v = 1.0 - (py + 0.5 + jitter[1] * height) / height
        d = V3(cam[4] + u * cam[8] + v * cam[12] - cam[0],
               cam[5] + u * cam[9] + v * cam[13] - cam[1],
               cam[6] + u * cam[10] + v * cam[14] - cam[2]) - off
        ro = V3(cam[0] + off.x, cam[1] + off.y, cam[2] + off.z)
        col, _, r = ray_color_dense_rows(tables, ro, d, rng, max_depth)
        cx, cy, cz = cx + col.x, cy + col.y, cz + col.z
        rays = rays + r
    inv = 1.0 / spp
    col = torch.stack([cx * inv, cy * inv, cz * inv], dim=-1)
    return (col, rays) if with_stats else col
