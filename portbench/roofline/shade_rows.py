"""Least time of the profiled stretch's `shade_rows.cu` launches (the
white-texel shade kernel), from the frames' exact ray counts.

Live lanes: a lane shaded at bounce d casts at most one NEE shadow ray and
one extension ray there, and each such ray comes from a lane shaded live
at that bounce, so the lanes shaded live over a frame are at least half of
its bounce rays (the exact count less the R primaries).

Counted once each: per live lane, its state, rng word, shading row and
NEE inputs read (252 B) and its new state and two rays written (180 B);
per launch, the emissive triangles' rows (40 f32 each) read once;
operations, 300 f32 a live lane. Frozen copies of `chip_smoke.py`'s
`shade_bytes` and `SHADE_OPS`.

Why a lower bound: dead lanes, which the kernel reads and writes, and the
half of the bounce rays that a lane may cast beside the other are left
out. The share can only read low, never over 100%."""

from portbench.lib import peaks

SHADE_OPS = 300
LANE_BYTES = 20 * 4 + 8 + 40 * 4 + 4 + 27 * 4 + 8 + 16 * 4
ROW_BYTES = 40 * 4


def least_s(trace, window) -> float:
    launches = trace.launches.get("shade_rows", 0)
    live = max(trace.rays - trace.frames * window.pixels, 0.0) / 2
    nbytes = live * LANE_BYTES + launches * window.light_rows * ROW_BYTES
    return peaks.least_s(nbytes, live * SHADE_OPS)
