"""Whether what the window produced is correct: the numbers compared with
the plain reference (`portbench/reference/`), each beside its limit.

For each snapshot of a traced frame (the accumulator before and after one
`render_frame`, or one step of a sharded renderer), the reference traces the
frame again at the checked pixels from the scene compiler's raw arrays and
adds its sample to the program's accumulator before the frame, in the
accumulator's own f32 operation. The sample is the frame's own stream under
the frame's jitter, or, where the snapshot carries `streams` (a list of PCG
stream indices) and `jitter` (the two f32 values the step was given), the
mean of those streams under that one jitter, as a sample-sharded step
makes it: each stream's radiance times 1 / len(streams), summed in list
order, in f32.

- `drift_pct`: the share of checked pixels (x frames) whose accumulator
  after the frame differs from that by more than rtol 1e-5 + atol 1e-6, or
  whose sample count is off: roundings of the same path included;
- `parted_pct`: of those, the share whose gap is also more than 1% of the
  reference's sample (or a whole sample count): the paths that part
  between the two sides;
- `rays_gap_pct`: the gap between the program's exact ray count of the
  checked frames together and the reference's (every stream's rays,
  scaled from the checked pixels to the frame when they are a sample), as
  a share of the reference's;
- `ranks_off_pct`, only where some snapshot carries `rank_sums` (each
  rank's accumulator after the step as its float64 sum and its element
  count): the share of those ranks whose accumulator differs from rank
  0's in either number. Sample sharding leaves the whole frame on every
  rank; the snapshot's `after` is rank 0's.

For each snapshot of a present, the reference runs the post-process chain
on the program's accumulator and TAA history before it:

- `ldr_off_pct`: the share of the 8-bit image's values more than one
  level off (and, in the record loop, of the encoded PNG's);
- `history_off_pct`: the share of the new TAA history's values off by
  more than rtol 1e-5 + atol 1e-6.

A snapshot whose frame was seeded from the G-buffer (`gbuffer`) is traced
as the frame it stands for: at lens radius 0 the seeded radiance is the
traced one bit for bit, and the program counts the G-buffer's W*H primary
rays in the place of the tracer's own (which a seeded tracer does not
cast), so the reference's count, a primary ray a pixel, holds for both.
The check raises on a seeded snapshot whose camera has a lens radius above
0, rather than compare against another estimator.

The scene is the configuration's preset with the GLB of its `"model"`, if
it names one (`drivers.scene_source`, the input the loops build from too);
a textured scene's images are decoded and sampled by the reference itself
(`reference/textures.py`).

The reference follows the program from the program's state before each
checked frame (its accumulator and history), which the window built over
thousands of frames; the start (a first frame overwrites the accumulator)
is the record loop's first sample of every recorded frame.

`control=True` puts the reference, computed in bfloat16 (the precision
below the configuration's float32), in the program's place: the benchmark's
control, which has to come out not correct.
"""

from __future__ import annotations

import numpy as np

from . import drivers

RTOL, ATOL = 1e-5, 1e-6
PART = 0.01  # a sample this far off is another path, not a rounding


def scene_arrays(scene: str, width: int, height: int, t: float,
                 **source) -> dict:
    """The scene compiler's raw arrays at time t (the input both sides
    start from), its encoded texture images and the camera. `source` is
    what else builds the scene (`drivers.scene_source`: a model's GLB)."""
    from webgpu_raytracer_tpu_torch import NativeWorld
    w = NativeWorld(scene, **source)
    if t:
        w.update(t)
    w.update_camera(width, height)
    out = {k: np.array(getattr(w, k)()) for k in
           ("topology", "vertices", "normals", "uvs", "instances", "lights")}
    out["textures"] = [w.texture(i) for i in range(w.texture_count())]
    out["camera"] = np.array(w.camera(), np.float32)
    return out


def _off(a, b, levels: int = 1) -> float:
    """% of 8-bit values more than `levels` apart."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    return 100.0 * float((np.abs(a - b) > levels).mean())


def _far(got, want) -> "torch.Tensor":
    import torch
    return ~torch.isclose(got, want, rtol=RTOL, atol=ATOL)


def sample(scene, camera, snap: dict, width: int, height: int,
           max_depth: int) -> tuple:
    """(radiance (N, 3), rays (N,)) of a snapshot's sample at its pixels,
    in the scene's precision: the frame's own stream, or the mean of the
    snapshot's `streams` under its `jitter`."""
    from portbench.reference import pathtrace as pt
    args = (scene, camera, snap["pixels"], snap["frame"], width, height,
            max_depth)
    if "streams" not in snap:
        return pt.radiance(*args)
    share = 1.0 / len(snap["streams"])
    col = rays = 0
    for k in snap["streams"]:
        c, r = pt.radiance(*args, stream=k, jitter=snap["jitter"])
        col, rays = col + c * share, rays + r
    return col, rays


def check(window, cfg: dict, device, control: bool = False) -> tuple:
    """({number: value}, facts) of one window's snapshots; the facts are
    the scene's triangle and emissive-triangle counts and the number of
    pixel samples checked."""
    import torch
    from portbench.reference import pathtrace as pt
    from portbench.reference import post

    W, H, D = cfg["width"], cfg["height"], cfg["max_depth"]
    lo = torch.bfloat16
    source = drivers.scene_source(cfg)
    worlds = {}

    def world(t):
        if t not in worlds:
            arr = scene_arrays(cfg["scene"], W, H, t, **source)
            tables = pt.world_tables(arr)
            if tables["textures"] is not None and cfg.get("backend") == "bvh":
                raise ValueError("a textured scene on the BVH path, which "
                                 "samples level 0 at every bounce: the "
                                 "reference follows the dense path's levels")
            worlds[t] = (arr["camera"], pt.Scene(tables, device),
                         pt.Scene(tables, device, lo) if control else None,
                         tables)
        return worlds[t]

    parted = drifted = checked = 0
    rays_got = rays_want = ldr_off = hist_off = 0.0
    png_off = None
    ranks = ranks_off = 0
    for s in window.snapshots:
        cam, sc, sc_lo, tables = world(s["time"])
        if s.get("gbuffer") and cam[3] > 0.0:
            raise ValueError(f"a frame seeded from the G-buffer under a lens "
                             f"of radius {float(cam[3])}: its radiance is "
                             f"not the traced frame's, which the reference "
                             f"traces")
        px = s["pixels"]
        ref, ref_rays = sample(sc, cam, s, W, H, D)
        one = torch.ones_like(ref[:, :1])
        before = s["before"][px]
        first = s["frame"] == 1
        want = torch.cat([ref, one], 1)
        if not first:
            want = before + want
        est = float(ref_rays.sum()) * W * H / px.numel()
        if control:
            c, c_rays = sample(sc_lo, cam, s, W, H, D)
            got = torch.cat([c.float(), one], 1)
            if not first:
                got = before + got
            rays = float(c_rays.sum()) * W * H / px.numel()
        else:
            got = s["after"][px]
            rays = float(s["rays"])
        gap = (got - want).abs()
        drift = gap > RTOL * want.abs() + ATOL
        size = torch.cat([ref, one], 1).abs()
        drifted += int(drift.any(1).sum())
        parted += int((drift & (gap > PART * size)).any(1).sum())
        checked += px.numel()
        rays_got += rays
        rays_want += est
        sums = s.get("rank_sums")
        if sums is not None:
            ranks += len(sums)
            ranks_off += sum(tuple(r) != tuple(sums[0]) for r in sums)

        p = s.get("present")
        if p is None:
            continue
        acc = p["accum"].view(H, W, 4)
        jit = pt.average_jitter(p["frames"], W, H)
        ref_ldr, ref_hist = post.present(acc, p["hist_before"], p["frame"],
                                         jit)
        if control:
            ldr, hist = post.present(acc.to(lo), p["hist_before"].to(lo),
                                     p["frame"], jit)
            ldr, hist = ldr.cpu().numpy(), hist.float()
        else:
            ldr, hist = p["ldr"], p["hist_after"]
        ref_ldr = ref_ldr.cpu().numpy()
        ldr_off = max(ldr_off, _off(ldr, ref_ldr))
        hist_off = max(hist_off, 100.0 * float(
            _far(hist, ref_hist).float().mean()))
        if "png" in p:
            img = ldr if control else post.read_png(p["png"])
            png_off = max(png_off or 0.0, _off(img, ref_ldr))

    numbers = {"parted_pct": 100.0 * parted / max(checked, 1),
               "drift_pct": 100.0 * drifted / max(checked, 1),
               "rays_gap_pct": 100.0 * abs(rays_got - rays_want)
               / max(rays_want, 1.0), "ldr_off_pct": ldr_off,
               "history_off_pct": hist_off}
    if png_off is not None:
        numbers["png_off_pct"] = png_off
    if ranks:
        numbers["ranks_off_pct"] = 100.0 * ranks_off / ranks
    tables = next(iter(worlds.values()))[3]
    return numbers, {"tris": int(tables["shade"].shape[0]),
                     "light_rows": int(tables["light_count"]),
                     "checked": checked}
