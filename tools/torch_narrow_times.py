#!/usr/bin/env python3
"""Time the PyTorch port's two narrow-phase kernels, the two exact culls
ahead of them and the `spheres` frames that run on them, for the checkout
in the current directory.

    cd <checkout root> && python3 <this file>

It imports `webgpu_raytracer_tpu_torch` from the current directory, so one
copy of this script can time two checkouts one after the other on one card
(parent, change, change, parent), which is how two versions of a kernel are
compared. It uses only calls that every version since the scan path has:
`cuda_jobs.worklists`, `cuda_scan.cluster_keys`, `cuda_jobs.job_sweep`,
`cuda_scan.scan_sweep`, `trace_pixels_dense(narrow=)`. Where the tables
carry the spheres' box (`WorldTables.box`), the sort and the culls take it
as the main path gives it; a version whose tables have none takes the
spheres and reduces them itself.

Measured, all on `spheres` 512^2 depth 8 (the shapes `chip_smoke.py` times):
- the job sweep and the scan sweep of the fused bounce-1 sweep (524,288
  lanes), closest + rows and any-hit: device ms per call, 100 launches
  between one pair of CUDA events after 3 warm-ups;
- the two culls of that sweep (`cluster_cull` over 4,096 groups of 128
  lanes, `cluster_cull_keyed` over 512 tiles of 1,024), the same way, with
  the number of survivors each found (two versions must agree on it);
- the job sweep of the group with the longest worklist alone (one block on
  one SM: what bounds the launch from below), and of that group 132 times
  over (one block on every SM);
- frames 2..5 of `trace_pixels_dense` through `narrow="jobs"` and `"scan"`:
  wall ms per frame ending in a synchronise, and the mean radiance.
Prints the card's name and power limit first, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from webgpu_raytracer_tpu_torch import NativeWorld  # noqa: E402
from webgpu_raytracer_tpu_torch.ops import cuda_jobs, cuda_scan  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.cluster_cull import sort_keyed  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.coherence import coherence_sort  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.dense_trace import (  # noqa: E402
    bounce_rays, trace_pixels_dense)
from webgpu_raytracer_tpu_torch.ops.tune import M_TILE2, M_TILE3  # noqa: E402
from webgpu_raytracer_tpu_torch.render.worldtris import (  # noqa: E402
    build_world_tables)

W = H = 512
DEPTH = 8
LAUNCHES = 100
FRAMES = 5


def device_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(LAUNCHES):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / LAUNCHES


def frame_ms(tables, camera, narrow: str) -> tuple[float, float]:
    jitter = torch.zeros(2, device=tables.device)
    means = []

    def frame(f):
        means.append(trace_pixels_dense(tables, camera, f, jitter, W, H, 1,
                                        DEPTH, narrow=narrow).mean())

    frame(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(2, FRAMES + 1):
        frame(f)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (FRAMES - 1)
    return ms, float(torch.stack(means).mean())


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    world = NativeWorld("spheres")
    world.update_camera(W, H)
    tables = build_world_tables(world, "cuda")
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
    R = W * H
    rays8 = bounce_rays(tables, camera, W, H, 1, DEPTH)

    box = getattr(tables, "box", None)
    sort_by = tables.spheres if box is None else box
    with_box = () if box is None else (box,)

    def cull():
        return cuda_jobs.worklists(tables.spheres, rays_j, g, *with_box)

    def cull_keyed():
        return cuda_scan.cluster_keys(tables.spheres, rays_s, m, *with_box)

    g = M_TILE3
    rays_j, perm_j = coherence_sort(rays8, sort_by, g, R)
    order_j, counts_j = cull()
    m = M_TILE2
    rays_s, perm_s = coherence_sort(rays8, sort_by, m, R)
    lists = sort_keyed(cull_keyed())

    def jobs(any_hit):
        return cuda_jobs.job_sweep(tables, rays_j, perm_j, order_j, counts_j,
                                   g, 2 * R, any_hit, R)

    def scan(any_hit):
        return cuda_scan.scan_sweep(tables, rays_s, perm_s, *lists, m, 2 * R,
                                    any_hit, R)

    def longest(n):
        """The longest worklist's group, n times over, as a stack of its
        own."""
        k = int(counts_j.argmax())
        rs = rays_j[:, k * g:(k + 1) * g].repeat(1, n).contiguous()
        pm = torch.arange(n * g, dtype=torch.int32, device="cuda")
        od = order_j[k:k + 1].repeat(n, 1).contiguous()
        cn = counts_j[k:k + 1].repeat(n).contiguous()
        return device_ms(lambda: cuda_jobs.job_sweep(
            tables, rs, pm, od, cn, g, n * g, False, 0))

    t_j, i_j, _ = jobs(False)
    t_s, i_s, _ = scan(False)
    assert torch.equal(i_j, i_s) and torch.equal(t_j.view(torch.int32),
                                                 t_s.view(torch.int32))
    out = {"checkout": os.getcwd(),
           "cull_ms": device_ms(cull),
           "cull_keyed_ms": device_ms(cull_keyed),
           "cull_ms_again": device_ms(cull),
           "cull_survivors": int(counts_j.sum()),
           "cull_keyed_survivors": int(lists[2].sum()),
           "job_ms": device_ms(lambda: jobs(False)),
           "scan_ms": device_ms(lambda: scan(False)),
           "job_any_ms": device_ms(lambda: jobs(True)),
           "scan_any_ms": device_ms(lambda: scan(True)),
           "job_ms_again": device_ms(lambda: jobs(False)),
           "longest_worklist": int(counts_j.max()),
           "longest_group_alone_ms": longest(1),
           "longest_group_x132_ms": longest(132)}
    for narrow in ("jobs", "scan"):
        ms, mean = frame_ms(tables, camera, narrow)
        out[f"frame_{narrow}_ms"] = ms
        out[f"mean_{narrow}"] = mean
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
