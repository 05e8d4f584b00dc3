"""Least time of the profiled stretch's textured shade launches
(`shade_rows.cu`'s `<true>` instantiation), from the frames' exact ray
counts, on the `tex_instances` model.

Live lanes, as `roofline/shade_rows.py` counts them: at least half of the
frames' bounce rays (the exact count less the R primaries, which a seeded
frame's G-buffer casts in the tracer's place). Per live lane the
white-texel lane's bytes and operations (`shade_rows.py`'s `LANE_BYTES`
and `SHADE_OPS`), the texture coordinates' barycentrics (48 operations),
and the texel quads it reads: one 16-byte row of four level-0 words (a
bilinear sample's four taps) for each bound slot of its hit (base colour
and normal map on both sphere materials, metallic-roughness and emissive
on the metal) and for its light sample's emission where the picked light
is the textured one, 52 operations each. Per launch, the emissive rows
once. Frozen copies of `chip_smoke.py`'s textured bound (432 bytes a lane
plus 16 a quad; `SHADE_OPS` + `TEXCOORD_OPS` a lane, `TEXEL_OPS` a quad).

`QUADS` is the least number of quads a live lane read on any bounce of
one 1920x1080 depth-8 frame of `tex_instances` (0.8434 at bounce 0, where
the room's untextured walls take most lanes, 1.08-1.22 at bounces 1-7;
counted on an H100 over the shade's inputs,
`ops/dense_trace.bounce_inputs`), rounded down: the frame's quads over its
live lanes are at least that.

Why a lower bound: dead lanes, which the kernel reads and writes, half of
the bounce rays and every quad past that least share are left out. The
share can only read low, never over 100%."""

from portbench.lib import peaks

SHADE_OPS = 300
TEXCOORD_OPS = 48
TEXEL_OPS = 52
LANE_BYTES = 20 * 4 + 8 + 40 * 4 + 4 + 27 * 4 + 8 + 16 * 4
QUAD_BYTES = 16
ROW_BYTES = 40 * 4
QUADS = 0.8


def least_s(trace, window) -> float:
    launches = trace.launches.get("shade_rows_tex", 0)
    live = max(trace.rays - trace.frames * window.pixels, 0.0) / 2
    nbytes = (live * (LANE_BYTES + QUADS * QUAD_BYTES)
              + launches * window.light_rows * ROW_BYTES)
    ops = live * (SHADE_OPS + TEXCOORD_OPS + QUADS * TEXEL_OPS)
    return peaks.least_s(nbytes, ops)
