"""Least time of the profiled stretch's `bvh_walk.cu` launches (the closest
and any-hit walks of the BVH path), from the frames' exact ray counts.

Every ray the program counts (primaries, and each bounce's NEE shadow and
extension lanes that were live) is one lane of one walk: its origin and
direction read (24 B) and its result written, at least 1 B (the any-hit
walk's flag). Bytes only: the operations hang on the nodes and triangles
a walk happens to visit, which the count of the work does not.

Why a lower bound: a closest hit writes 12 B (t, triangle, instance), not
1; the active flags, a shadow ray's own t_max, the dead lanes and the
scene's node, triangle and instance arrays (read at least once a launch;
a few KB for cornell) are left out, and so are the nodes and triangles
tested. The share can only read low, never over 100%. Frozen from
`chip_smoke.py`'s `walk_bound` (its per-ray bytes)."""

from portbench.lib import peaks

RAY_BYTES = 24 + 1


def least_s(trace, window) -> float:
    return peaks.least_s(trace.rays * RAY_BYTES, 0.0)
