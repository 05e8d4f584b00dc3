"""Least time of the profiled stretch's `bvh_shade.cu` launches (the BVH
path's bounce), from the frames' exact ray counts.

Live lanes: a lane shaded at bounce d casts at most one NEE shadow ray and
one extension ray there, and each such ray comes from a lane that found a
hit at that bounce, so the found lanes shaded over a frame are at least
half of its bounce rays (the exact count less the primaries, one a pixel
a frame: one sample a pixel a frame on the profiled card, as every cell
that reads this traces).

Counted once each: per found lane, its inputs (path state, rng word, ray,
and the walk's hit: 92 B) and outputs (new state, rng word, next ray, its
flag, the NEE ray and its t_max and flag: 114 B); operations, 650 a found
lane, each a separately rounded instruction (the file is built with
--fmad=false), so twice as many against the peak that counts an FMA as
two. Frozen copies of `chip_smoke.py`'s `bvh_shade_bytes` (its per-lane
bytes) and `BVH_SHADE_OPS`.

Why a lower bound: dead lanes, which the kernel reads and writes, the
half of the bounce rays a lane may cast beside the other, and the rows
the found lanes gather (triangles, vertices, instances, light rows) are
left out. The share can only read low, never over 100%."""

from portbench.lib import peaks

BVH_SHADE_OPS = 650
LANE_IN = 13 * 4 + 8 + 24 + 8
LANE_OUT = 13 * 4 + 8 + 24 + 1 + 24 + 4 + 1


def least_s(trace, window) -> float:
    live = max(trace.rays - trace.frames * window.pixels, 0.0) / 2
    return peaks.least_s(live * (LANE_IN + LANE_OUT),
                         2 * live * BVH_SHADE_OPS)
