"""Least time of the profiled stretch's `dense_sweep.cu` launches (the
single-tile sweep), from the frames' exact ray counts.

Counted once each, and only what the frames need:
- per launch, the Plucker features of the scene's triangles, 16 x 5 f32 a
  triangle, read once (the kernel stages them per block; the re-reads are
  not counted);
- per ray traced (the program's exact count: primaries, and each bounce's
  NEE shadow and extension lanes that were live): its 8-float ray read
  (32 B), its distance and index written (8 B);
- per frame, the primary sweep's shading rows of its R lanes (40 f32 each)
  written;
- operations: 45 f32 operations a (ray, triangle) test; a primary needs
  every triangle tested, a bounce ray at least one (its tests are not
  split between shadow rays, which may stop at an occluder, and extension
  rays, which may not).

Why a lower bound: dead lanes, which the kernel still reads and writes,
the extension sweeps' rows and every re-read are left out, and a bounce
ray is counted at one test. The share can only read low, never over 100%.
The constants are frozen copies of `chip_smoke.py`'s (`SWEEP_OPS`, the
byte counts of `check_sweep`)."""

from portbench.lib import peaks

SWEEP_OPS = 45
FEATURE_BYTES = 16 * 5 * 4
RAY_BYTES = 8 * 4 + 4 + 4
ROW_BYTES = 40 * 4


def least_s(trace, window) -> float:
    launches = trace.launches.get("dense_sweep", 0)
    primaries = trace.frames * window.pixels
    bounce = max(trace.rays - primaries, 0.0)
    nbytes = (launches * window.tris * FEATURE_BYTES + trace.rays * RAY_BYTES
              + primaries * ROW_BYTES)
    ops = SWEEP_OPS * (primaries * window.tris + bounce)
    return peaks.least_s(nbytes, ops)
