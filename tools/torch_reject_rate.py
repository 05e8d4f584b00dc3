#!/usr/bin/env python3
"""Measure what a conservative box reject ahead of the exact culls' pair
tests would save, on the fused bounce-1 ray stack of a scene.

    cd <checkout root> && python3 tools/torch_reject_rate.py [res] [scene]

The exact culls (`webgpu_raytracer_tpu_torch/csrc/cluster_cull.cu`) test
every (live lane, cluster) pair. A reject that drops a (subgroup of lanes,
cluster) pair from the subgroup's bounds alone would skip most of that
work if it rejected most pairs, but it may never reject a pair that
`pair_ok` / `pair_keyed` admit as computed in f32, because the culls'
outputs must stay bit-equal to their plain versions. This script holds the
one reject that has a proof (`candidates_plain`: the box of the subgroup's
clipped segments against the cluster's sphere, with a margin that covers
the f32 tests' cancellation; the argument is in its docstring), counts the
pairs it passes on for subgroups of 32 and 128 lanes, and checks that it
loses no pair the exact test admits. Plain PyTorch, on the card when there
is one (it prints the device), else on the CPU; default 512^2 `spheres`.

The kernels do not carry this reject: on `spheres` it passes on nearly
every pair, because a subgroup's rays share a direction bin of the
coherence sort, not a direction, and run to the far side of the scene.
Beside it the script counts what the cone cull's test
(`cone_worklists_plain`, an origin sphere and a direction cone a subgroup)
would pass on, for which no such proof is written, and how often the
kernels' first stage (some lane with disc >= 0) leads on to the rest of
the test.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from webgpu_raytracer_tpu_torch import NativeWorld  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (  # noqa: E402
    CLUSTER_CHUNK, LANE_CHUNK, _pair_terms, cone_worklists_plain, lane_terms,
    pair_keyed, pair_ok)
from webgpu_raytracer_tpu_torch.ops.coherence import (  # noqa: E402
    BIG, coherence_sort)
from webgpu_raytracer_tpu_torch.ops.dense_trace import (  # noqa: E402
    bounce_rays)
from webgpu_raytracer_tpu_torch.ops.tune import M_TILE3  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.v3 import sqrt_rn  # noqa: E402
from webgpu_raytracer_tpu_torch.render.worldtris import (  # noqa: E402
    build_world_tables)

REJECT_MARGIN = 2.0 ** -7
REJECT_T_PAD = 1.0 + 2.0 ** -10
REJECT_BOX_PAD = 2.0 ** -20
REJECT_DD_MIN, REJECT_DD_MAX = 2.0 ** -30, 2.0 ** 30
REJECT_COORD_MAX = 2.0 ** 30
REJECT_REACH_MAX = 2.0 ** 34
REJECT_NEAR2_MIN = 2.0 ** -60


def segment_boxes(rays_s, dd, t_clip, sub: int):
    """Per `sub`-lane subgroup of a sorted (8, rp) stack: (lo (S, 3),
    hi (S, 3), live (S,), sane (S,)). [lo, hi] holds the segment
    o + t d, 0 <= t <= t_clip (1 + 2^-10), of every live lane (t_clip > 0)
    of the subgroup, each side padded by 2^-20 of its largest coordinate
    (which covers the rounding of the end points); `live` says whether it
    has a live lane, `sane` whether every live lane's |d|^2 lies in
    [2^-30, 2^30] and no box coordinate exceeds 2^30 in magnitude."""
    rp = rays_s.shape[1]
    d, o = rays_s[0:3], rays_s[3:6]
    alive = t_clip > 0.0
    end = o + (t_clip * REJECT_T_PAD)[None] * d
    lo = torch.where(alive[None], torch.minimum(o, end), BIG)
    hi = torch.where(alive[None], torch.maximum(o, end), -BIG)
    lo = lo.view(3, rp // sub, sub).amin(2).T
    hi = hi.view(3, rp // sub, sub).amax(2).T
    pad = torch.maximum(lo.abs(), hi.abs()) * REJECT_BOX_PAD
    lo, hi = lo - pad, hi + pad
    dd_ok = ((dd >= REJECT_DD_MIN) & (dd <= REJECT_DD_MAX)) | ~alive
    sane = (dd_ok.view(-1, sub).all(1)
            & (torch.maximum(lo.abs(), hi.abs()) <= REJECT_COORD_MAX).all(1))
    return lo, hi, alive.view(-1, sub).any(1), sane


def candidates_plain(spheres: torch.Tensor, rays_s: torch.Tensor, sub: int,
                     box: torch.Tensor):
    """(S, Ct) bool: the (subgroup of `sub` lanes, cluster) pairs that the
    exact culls' kernels test lane by lane; the others they reject from the
    subgroup's box alone. Conservative: it holds every pair in which some
    lane passes `pair_ok` or `pair_keyed` as computed in f32.

    A pair is rejected when the subgroup is sane (`segment_boxes`), and
    near^2 > (r + 2^-7 (reach + r))^2 with near the distance from the
    cluster's centre c to the box, reach the sum over the axes of the
    distance from c to the box's far side (at least |o - c| of every lane),
    near^2 >= 2^-60 and r + 2^-7 (reach + r) < 2^34. A subgroup with no
    live lane has no candidate, nor has a padding cluster (r < 0); a
    subgroup that is not sane, or a NaN anywhere, rejects nothing.

    Why no admitted pair is lost. Take a live lane (o, d, t_clip) of a sane
    subgroup and a sphere (c, r >= 0), and write eps = 2^-24, u = |o - c|,
    D = |d|. The pair tests work on oc^ = fl(o - c), the exact offset from
    a centre c^ with |c^ - c| <= eps u; let u^ = |oc^| and M = D^2 (u^^2 +
    r^2). Within the guards no intermediate overflows, and an underflow
    costs at most 2^-149 against the 2^-114 that eps M is at least. Then
    (gamma_k = k eps / (1 - k eps)):
    - b^ = d . oc^ + e_b with |e_b| <= gamma_3 D u^; cc^ = u^^2 - r^2 + e_c
      with |e_c| <= gamma_5 (u^^2 + r^2); dd^ = D^2 (1 + theta), |theta| <=
      gamma_3. So fl(b^ b^) - fl(dd^ cc^), whose sign is disc^'s, differs
      from the exact Delta = (d . oc^)^2 - D^2 (u^^2 - r^2) by at most
      17 eps M. With p the distance from c^ to the line, Delta = D^2 (r^2 -
      p^2): disc^ >= 0 gives p^2 <= r^2 + 17 eps (u^^2 + r^2).
    - Along the line, |o + t d - c^|^2 = r^2 + ((D^2 t + d . oc^)^2 -
      Delta) / D^2. The far-end tests (b_hi >= 0 or disc >= b_hi^2; keyed
      -b - sq <= dd t_clip) hold in f32 only if the closest approach lies
      at t <= t' + gamma_3 u^ / D, or the point at t' lies within
      sqrt(r^2 + 32 eps (u^^2 + r^2)) of c^, for a t' <= t_clip (1 + 1e-6)
      (1 + gamma_5) < t_clip (1 + 2^-10); the near-end tests (a_lo <= 0 or
      disc >= a_lo^2; keyed -b + sq >= dd t_min) the same about t >=
      -gamma_3 u^ / D and a point at some t'' >= 0. The distance to c^ is
      convex in t, so in every case some point of the segment 0 <= t <=
      t_clip (1 + 2^-10) lies within sqrt(r^2 + 32 eps (u^^2 + r^2)) +
      gamma_3 u^ of c^, and so within r + 1.4e-3 (u + r) of c.
    The box holds that segment, so near is at most that distance, and reach
    is at least u: an admitted pair has near <= r + 1.4e-3 (reach + r),
    under a fifth of the margin tested. The test's own roundings are
    relative errors of a few eps on both sides of a comparison that has
    that slack. Every operation is a separately rounded f32 operation in
    the order written here, so the kernels reject the same pairs."""
    dd, t_clip = lane_terms(rays_s, box)
    lo, hi, live, sane = segment_boxes(rays_s, dd, t_clip, sub)
    out = torch.empty((lo.shape[0], spheres.shape[0]), dtype=torch.bool,
                      device=rays_s.device)
    step = max(1, LANE_CHUNK // CLUSTER_CHUNK)
    r = spheres[None, :, 3]
    for s0 in range(0, lo.shape[0], step):
        s = slice(s0, s0 + step)
        near2 = reach = None
        for ax in range(3):
            c = spheres[None, :, ax]
            a = lo[s, ax, None] - c
            e = c - hi[s, ax, None]
            n = torch.clamp(torch.maximum(a, e), min=0.0)
            f = -torch.minimum(a, e)
            near2 = n * n if near2 is None else near2 + n * n
            reach = f if reach is None else reach + f
        rm = r + (reach + r) * REJECT_MARGIN
        reject = ((near2 > rm * rm) & (near2 >= REJECT_NEAR2_MIN)
                  & (rm < REJECT_REACH_MAX) & sane[s, None])
        out[s] = live[s, None] & (r >= 0.0) & ~reject
    return out


def admitted(spheres, rays_s, sub: int, box):
    """Three (S, Ct) bool maps: some lane of the subgroup passes `pair_ok`,
    passes `pair_keyed`, is live with disc >= 0 (the kernels' first stage,
    after which they run the rest of the test)."""
    dd, t_clip = lane_terms(rays_s, box)
    dlen = sqrt_rn(dd)
    rp, ct = rays_s.shape[1], spheres.shape[0]
    out = torch.zeros((3, rp // sub, ct), dtype=torch.bool,
                      device=rays_s.device)
    step = sub * max(1, LANE_CHUNK // sub)
    for l0 in range(0, rp, step):
        lanes = slice(l0, l0 + step)
        for c0 in range(0, ct, CLUSTER_CHUNK):
            sph = spheres[c0:c0 + CLUSTER_CHUNK]
            _, disc, r = _pair_terms(rays_s[:, lanes], dd[lanes], sph)
            oks = (pair_ok(rays_s[:, lanes], dd[lanes], t_clip[lanes], sph),
                   pair_keyed(rays_s[:, lanes], dd[lanes], dlen[lanes],
                              t_clip[lanes], sph)[0],
                   (disc >= 0.0) & (t_clip[lanes] > 0.0)[None] & (r >= 0.0))
            for k, ok in enumerate(oks):
                out[k, l0 // sub:(l0 + step) // sub, c0:c0 + CLUSTER_CHUNK] \
                    = ok.view(ok.shape[0], -1, sub).any(2).T
    return out[0], out[1], out[2]


def main(argv: list[str]) -> int:
    res = int(argv[0]) if argv else 512
    scene = argv[1] if len(argv) > 1 else "spheres"
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    print("device:", torch.cuda.get_device_name(0) if dev == "cuda" else "cpu")
    world = NativeWorld(scene)
    world.update_camera(res, res)
    tables = build_world_tables(world, dev)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    rays8 = bounce_rays(tables, cam, res, res, 1, 8)
    rays_s, _ = coherence_sort(rays8, tables.box, M_TILE3, res * res)
    ct = tables.spheres.shape[0]
    for sub in (32, 128):
        cand = candidates_plain(tables.spheres, rays_s, sub, tables.box)
        ok, ok_keyed, stage1 = admitted(tables.spheres, rays_s, sub,
                                        tables.box)
        lost = int(((ok | ok_keyed) & ~cand).sum())
        pairs = max(int(cand.any(1).sum()), 1) * ct
        cone = int(cone_worklists_plain(tables.spheres, rays_s, sub,
                                        tables.box, sub)[2].sum())
        print(f"{scene} {res}^2, subgroups of {sub} lanes: "
              f"{int(cand.any(1).sum())} live x {ct} clusters; the box "
              f"reject passes on {int(cand.sum())} pairs "
              f"({int(cand.sum()) / pairs:.4f}), the cone cull's test (no "
              f"proof against the f32 tests) on {cone} "
              f"({cone / pairs:.4f}); the exact tests admit "
              f"{int(ok.sum())} ({int(ok.sum()) / pairs:.4f}) unkeyed, "
              f"{int(ok_keyed.sum())} keyed; some lane has disc >= 0 in "
              f"{int(stage1.sum())} ({int(stage1.sum()) / pairs:.4f}); "
              f"admitted pairs rejected by the box: {lost}")
        assert lost == 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
