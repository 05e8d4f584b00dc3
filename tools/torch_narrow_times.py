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

    cd <checkout root> && python3 <this file> --chunks 32,64,128

Measured on `spheres` 512^2 depth 8 (the shapes `chip_smoke.py` times):
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

and on the shapes of the benchmark's `spheres-interactive` cell, `spheres`
720x480 depth 10 (`"cell"` in the JSON line): every job sweep of one frame
(the primary sweep, then the ten fused shadow | extension sweeps), caught
as `trace_pixels_dense` makes them and launched again, outside any graph:
- each sweep's device ms a launch, as above, and their sum: the job-sweep
  device ms of a frame;
- its stats (`with_stats=True`): tiles and pairs walked, the worklist
  lengths of the non-empty groups (quartiles, p90, max) and, where the
  checkout splits worklists, the groups split and the chunks walked;
- the group with the longest worklist alone, a stack of its own (one
  block), and beside SPREAD - 1 empty groups (where a checkout splits
  worklists, its chunks then spread over the card);
- with `--chunks`, the same sweeps again with `tune.JOB_CHUNK` set to each
  length given (a checkout that has it), their outputs held bit-equal to
  the first launch's, with the pairs walked and chunks.
Prints the card's name and power limit first, then one JSON line.
"""

from __future__ import annotations

import argparse
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
CELL_W, CELL_H, CELL_DEPTH = 720, 480, 10  # spheres-interactive's frame
CELL_LAUNCHES = 40
SPREAD = 1024  # groups of the stack that holds the longest one and no other


def device_ms(fn, launches: int = LAUNCHES) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


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


def cell_sweeps(tables, camera):
    """Every job sweep of one frame at the cell's shapes: the (args,
    kwargs) that `cuda_jobs.job_sweep` was called with, in order."""
    calls = []
    real = cuda_jobs.job_sweep

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    cuda_jobs.job_sweep = spy
    try:
        trace_pixels_dense(tables, camera, 1,
                           torch.zeros(2, device=tables.device), CELL_W,
                           CELL_H, 1, CELL_DEPTH)
    finally:
        cuda_jobs.job_sweep = real
    torch.cuda.synchronize()
    return calls


def quartiles(x: torch.Tensor) -> list:
    if x.numel() == 0:
        return []
    q = torch.tensor([0.25, 0.5, 0.75, 0.9, 1.0], device=x.device)
    return [float(v) for v in torch.quantile(x.float(), q)]


def cell(tables, camera, chunks: list) -> dict:
    """The cell's sweeps: times, stats, the longest group alone and, for
    each chunk length in `chunks`, the sweeps' times at that length."""
    calls = cell_sweeps(tables, camera)
    sweeps = []
    first = []
    for args, kw in calls:
        tab, rays_s, perm, order, counts, g, R, any_hit = args[:8]
        out = cuda_jobs.job_sweep(*args, **kw, with_stats=True)
        stats = out[-1]
        first.append(out[:-1] if isinstance(out, tuple) and len(out) > 2
                     else out[0])
        busy = counts[counts > 0]
        k = int(counts.argmax())
        dev = rays_s.device
        alone = (rays_s[:, k * g:(k + 1) * g].contiguous(),
                 torch.arange(g, dtype=torch.int32, device=dev),
                 order[k:k + 1].contiguous(), counts[k:k + 1].contiguous())
        spread_rays = torch.zeros((8, SPREAD * g), device=dev)
        spread_rays[:, :g] = alone[0]
        spread_counts = torch.zeros(SPREAD, dtype=torch.int32, device=dev)
        spread_counts[0] = counts[k]
        spread = (spread_rays,
                  torch.arange(SPREAD * g, dtype=torch.int32, device=dev),
                  order[k:k + 1].repeat(SPREAD, 1).contiguous(),
                  spread_counts)
        row = {"lanes": int(rays_s.shape[1]), "any_hit": bool(any_hit),
               "ms": device_ms(lambda: cuda_jobs.job_sweep(*args, **kw),
                                 CELL_LAUNCHES),
               "groups": int(counts.shape[0]),
               "nonempty_groups": int(busy.numel()),
               "jobs": int(counts.sum()),
               "tiles_walked": int(stats[:, 0].sum()),
               "pairs_walked": int(stats[:, 1].sum()),
               "worklist_q25_q50_q75_p90_max": quartiles(busy),
               "longest_group_alone_ms": device_ms(
                   lambda: cuda_jobs.job_sweep(tab, *alone, g, g, any_hit),
                   CELL_LAUNCHES),
               "longest_group_spread_ms": device_ms(
                   lambda: cuda_jobs.job_sweep(tab, *spread, g, SPREAD * g,
                                               any_hit),
                   CELL_LAUNCHES)}
        if stats.shape[1] > 3:
            row["groups_split"] = int((stats[:, 3] > 1).sum())
            row["chunks"] = int(stats[:, 3].clamp(min=1).sum())
        sweeps.append(row)
    out = {"sweeps": sweeps,
           "job_ms_frame": sum(r["ms"] for r in sweeps),
           "longest_alone_ms_frame": sum(r["longest_group_alone_ms"]
                                         for r in sweeps)}
    tune = getattr(cuda_jobs, "tune", None)
    if chunks and tune is not None:
        keep = tune.JOB_CHUNK
        by_chunk = {}
        try:
            for chunk in chunks:
                tune.JOB_CHUNK = chunk
                ms, pairs, jobs = [], 0, 0
                for (args, kw), want in zip(calls, first):
                    *got, stats = cuda_jobs.job_sweep(*args, **kw,
                                                      with_stats=True)
                    want = want if isinstance(want, tuple) else (want,)
                    assert all(torch.equal(a.view(torch.uint8),
                                           b.view(torch.uint8))
                               for a, b in zip(got, want)), chunk
                    pairs += int(stats[:, 1].sum())
                    jobs += int(stats[:, 3].clamp(min=1).sum())
                    ms.append(device_ms(
                        lambda: cuda_jobs.job_sweep(*args, **kw),
                        CELL_LAUNCHES))
                by_chunk[str(chunk)] = {"job_ms_frame": sum(ms), "ms": ms,
                                        "pairs_walked": pairs,
                                        "chunks": jobs}
        finally:
            tune.JOB_CHUNK = keep
        out["by_chunk"] = by_chunk
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunks", default="",
                        help="comma-separated JOB_CHUNK lengths to time the "
                             "cell's sweeps at")
    chunks = [int(c) for c in parser.parse_args().chunks.split(",") if c]
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
    del rays8, rays_j, rays_s, order_j, lists
    world.update_camera(CELL_W, CELL_H)
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
    out["cell"] = cell(tables, camera, chunks)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
