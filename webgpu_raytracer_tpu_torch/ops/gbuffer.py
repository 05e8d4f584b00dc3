"""Primary-visibility G-buffer pass.

The port of the JAX package's `ops/gbuffer.py`: per pixel, albedo (base
colour x base texture), the octahedral-packed shading normal, the hit
triangle and instance ids, normalized depth, and `wt_idx`, the world-tri
row that seeds bounce 0 (`trace_pixels_dense(seed_wt_idx=...)`). There is
no rasterizer: a primary-ray cast through the same camera gives the same
hit set, so the pass is one closest-hit sweep launch plus the shading of
the winner rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dense_trace import intersect_and_shade
from .v3 import V3, sqrt_rn
from ..render.worldtris import SHADE_COLS, WorldTables


class GBuffer(NamedTuple):
    albedo: torch.Tensor      # (H, W, 3) f32
    normal_oct: torch.Tensor  # (H, W, 2) f32 octahedral-packed
    tri_idx: torch.Tensor     # (H, W) i32 topology index (-1 miss)
    inst_idx: torch.Tensor    # (H, W) i32 instance index (-1 miss)
    depth: torch.Tensor       # (H, W) f32 in [0, 1]; 1.0 = miss
    wt_idx: torch.Tensor      # (H, W) i32 world-tri row (-1 miss)


def pack_normal_oct(n: V3):
    """Octahedral normal encoding."""
    denom = torch.abs(n.x) + torch.abs(n.y) + torch.abs(n.z)
    px = n.x / torch.clamp(denom, min=1e-20)
    py = n.y / torch.clamp(denom, min=1e-20)
    sx = torch.where(px >= 0.0, 1.0, -1.0)
    sy = torch.where(py >= 0.0, 1.0, -1.0)
    wrap_x = (1.0 - torch.abs(py)) * sx
    wrap_y = (1.0 - torch.abs(px)) * sy
    ox = torch.where(n.z < 0.0, wrap_x, px)
    oy = torch.where(n.z < 0.0, wrap_y, py)
    return ox, oy


def unpack_normal_oct(ox, oy) -> V3:
    """Inverse of pack_normal_oct."""
    z = 1.0 - torch.abs(ox) - torch.abs(oy)
    t = torch.clamp(-z, 0.0, 1.0)
    x = ox + torch.where(ox >= 0.0, -t, t)
    y = oy + torch.where(oy >= 0.0, -t, t)
    inv = 1.0 / torch.clamp(sqrt_rn(x * x + y * y + z * z), min=1e-20)
    return V3(x * inv, y * inv, z * inv)


def render_gbuffer(tables: WorldTables, textures, camera24: torch.Tensor,
                   width: int, height: int, jitter=None,
                   z_near: float = 0.01, z_far: float = 100.0,
                   narrow: str = "jobs") -> GBuffer:
    """Cast pinhole primary rays (the same rays `trace_pixels_dense` makes
    at lens radius 0) and emit the G-buffer set. `narrow` picks a
    multi-tile scene's narrow phase, as in `trace_pixels_dense`."""
    R = width * height
    lane = torch.arange(R, dtype=torch.int64, device=tables.device)
    px = (lane % width).to(torch.float32)
    py = (lane // width).to(torch.float32)
    jx = 0.0 if jitter is None else jitter[0]
    jy = 0.0 if jitter is None else jitter[1]
    u = (px + 0.5 + jx * width) / width
    v = 1.0 - (py + 0.5 + jy * height) / height

    c = camera24
    ro = V3(c[0].expand(R), c[1].expand(R), c[2].expand(R))
    rd = V3(c[4] + u * c[8] + v * c[12] - c[0],
            c[5] + u * c[9] + v * c[13] - c[1],
            c[6] + u * c[10] + v * c[14] - c[2])

    hit = intersect_and_shade(tables, textures, ro, rd, narrow=narrow)
    found = hit.wt >= 0

    rowT = hit.rowT
    tri = torch.where(found, rowT[SHADE_COLS["tri_idx"][0]].to(torch.int32),
                      -1)
    inst = torch.where(found,
                       rowT[SHADE_COLS["inst_idx"][0]].to(torch.int32), -1)

    ox, oy = pack_normal_oct(hit.normal)
    # Perspective-style normalized depth from the hit distance along the
    # view ray (the raster depth buffer's analogue; 1.0 encodes a miss).
    dlen = sqrt_rn(rd.x * rd.x + rd.y * rd.y + rd.z * rd.z)
    dist = hit.hit_t * dlen
    zn, zf = z_near, z_far
    # A tensor numerator: torch evaluates `scalar / tensor` as
    # reciprocal(tensor) * scalar, which rounds twice.
    # A fill, not a host-to-device copy: a captured frame step runs this.
    zn_t = torch.full((), zn, dtype=torch.float32, device=dist.device)
    depth = (zf / (zf - zn)) * (1.0 - zn_t / torch.clamp(dist, min=1e-20))
    depth = torch.where(found, torch.clamp(depth, 0.0, 0.999999), 1.0)

    def img(a):
        return a.reshape(height, width)

    albedo = torch.stack(
        [img(hit.albedo.x), img(hit.albedo.y), img(hit.albedo.z)], dim=-1)
    albedo = torch.where(found.reshape(height, width, 1), albedo, 0.0)
    normal_oct = torch.stack([img(ox), img(oy)], dim=-1)
    return GBuffer(albedo, normal_oct, img(tri), img(inst), img(depth),
                   img(torch.where(found, hit.wt, -1)))
