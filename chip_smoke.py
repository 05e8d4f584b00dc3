#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, render.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `webgpu_raytracer_tpu_torch/csrc/`
(and the shared native scene compiler), then:

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the cornell 512^2 main path, and times both;
2. drives the main path with the kernels' launch counts reset: 32 frames of
   `trace_pixels_dense` at cornell 512^2 d8 and 8 at 1920x1080 (each mean
   within 2% of bench.py's golden), then `Renderer(...).render_frame()` x 16
   and `present()`; every frame must launch the sweep 1 + 8 times and the
   shade kernel 8 times;
3. prints the card's name and power limit, one JSON line of per-kernel
   results, and last `{"ok": true, "device": {...}}`.

Every check is an assert; there is no fallback. Without CUDA it exits
non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import cuda_dense, shade_rows
from webgpu_raytracer_tpu_torch.ops.dense import (T_MAX, closest_plain,
                                                  ray_stack, rows_plain,
                                                  shadow_plain)
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu_torch.ops.rng import init_rng
from webgpu_raytracer_tpu_torch.ops.v3 import V3
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables

# bench.py's golden mean radiance (same estimator) and its 2% gate
GOLDENS = {"cornell_512": 0.3040, "cornell_1080p": 0.1766}
GOLDEN_TOL = 0.02
DEPTH = 8


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() over reps calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def camera_rays(camera: torch.Tensor, width: int, height: int):
    """Pixel-center pinhole rays (ro, rd) as V3 on the camera's device."""
    dev = camera.device
    lane = torch.arange(width * height, device=dev)
    u = ((lane % width).float() + 0.5) / width
    v = 1.0 - ((lane // width).float() + 0.5) / height
    c = camera
    rd = V3(*(c[4 + k] + u * c[8 + k] + v * c[12 + k] - c[k]
              for k in range(3)))
    ro = V3(*(c[k].expand(width * height).contiguous() for k in range(3)))
    return ro, rd


def sweep_inputs(camera, width, height):
    """The fused per-bounce layout at cornell 512^2: R camera rays (every
    4th with t_max 2.0) then R random rays inside the box (every 5th
    inactive, every 3rd with t_max 1.5), as one (8, 2R) numpy stack."""
    R = width * height
    ro_c, rd_c = camera_rays(camera, width, height)
    tmax_c = torch.where(torch.arange(R, device=camera.device) % 4 == 0,
                         2.0, T_MAX)
    cam8 = ray_stack(ro_c, rd_c, tmax_c).cpu().numpy()
    rs = np.random.default_rng(7)
    ro = np.stack([rs.uniform(-0.9, 0.9, R), rs.uniform(0.1, 1.9, R),
                   rs.uniform(-0.9, 0.9, R)]).astype(np.float32)
    rd = rs.normal(size=(3, R)).astype(np.float32)
    lane = np.arange(R)
    tmax = np.where(lane % 3 == 0, 1.5, T_MAX).astype(np.float32)
    tmax[lane % 5 == 0] = 0.0
    rnd8 = np.concatenate([rd, ro, tmax[None], np.zeros((1, R), np.float32)])
    return np.concatenate([cam8, rnd8], axis=1)


def near_ties(shade_table, rays8, idx_a, idx_b, lanes) -> float:
    """Max relative gap between the f64 Moller-Trumbore distances of two
    disagreeing winners (0 when there are none)."""
    if lanes.size == 0:
        return 0.0
    st = shade_table.astype(np.float64)
    v0, e1, e2 = st[:, 0:3], st[:, 3:6], st[:, 6:9]
    rd = rays8[0:3, lanes].T.astype(np.float64)
    ro = rays8[3:6, lanes].T.astype(np.float64)

    def mt(tris):
        s = ro - v0[tris]
        h = np.cross(rd, e2[tris])
        a = np.einsum("ij,ij->i", e1[tris], h)
        q = np.cross(s, e1[tris])
        return np.einsum("ij,ij->i", e2[tris], q) / a

    ta, tb = mt(idx_a[lanes]), mt(idx_b[lanes])
    return float((np.abs(ta - tb) / np.maximum(np.abs(ta), 1e-3)).max())


def check_sweep(tables, camera, width, height) -> dict:
    """Kernel 1 against its plain version: closest + rows, and any-hit."""
    dev = tables.device
    rays8_np = sweep_inputs(camera, width, height)
    rays8 = torch.from_numpy(rays8_np).to(dev)
    R = width * height
    t_k, i_k, rows_k = cuda_dense.closest_with_row(tables, rays8, R)
    occ_k = cuda_dense.shadow(tables, rays8)
    t_p, i_p = closest_plain(tables, rays8)
    rows_p = rows_plain(tables.shade_table, i_p[R:])
    occ_p = shadow_plain(tables, rays8)
    torch.cuda.synchronize()

    i_k, i_p = i_k.cpu().numpy(), i_p.cpu().numpy()
    t_k, t_p = t_k.cpu().numpy(), t_p.cpu().numpy()
    rows_k, rows_p = rows_k.cpu().numpy(), rows_p.cpu().numpy()
    hits = (i_p >= 0).mean()
    assert 0.3 < hits < 1.0, f"implausible hit fraction {hits}"
    differ = np.nonzero(i_k != i_p)[0]
    assert ((i_k >= 0) == (i_p >= 0)).all(), "hit/miss sets differ"
    gap = near_ties(tables.shade_table.cpu().numpy(), rays8_np, i_p, i_k,
                    differ)
    assert gap < 2e-3, f"non-tie winner flip (f64 gap {gap})"
    same = i_k == i_p
    assert (rows_k[:, same[R:]] == rows_p[:, same[R:]]).all(), "rows differ"
    t_err = float(np.abs(t_k[same] - t_p[same]).max())
    assert t_err <= 1e-6 * float(np.abs(t_p[same & (i_p >= 0)]).max())
    occ_agree = float((occ_k == occ_p).float().mean())
    assert occ_agree >= 0.999, f"occlusion agrees on {occ_agree:.4%}"
    print(f"sweep: {2 * R} lanes, hits {hits:.3f}, winners differ on "
          f"{differ.size} (f64 gap {gap:.2e}), occlusion agrees "
          f"{occ_agree:.6f}, t max abs err {t_err:.3e}")

    ms = median_ms(lambda: cuda_dense.closest_with_row(tables, rays8, R))
    ms_any = median_ms(lambda: cuda_dense.shadow(tables, rays8))
    plain_ms = median_ms(lambda: (rows_plain(tables.shade_table,
                                             closest_plain(tables,
                                                           rays8)[1][R:])),
                         reps=5)
    plain_any = median_ms(lambda: shadow_plain(tables, rays8), reps=5)
    print(f"sweep closest+rows: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms;"
          f" any-hit: kernel {ms_any:.4f} ms, plain {plain_any:.4f} ms")
    return dict(name="dense_sweep", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/dense_sweep.cu",
                replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:57",
                max_abs_err=t_err, ms=ms, plain_ms=plain_ms)


def bounce_inputs(tables, camera, width, height, depth):
    """(state, rng, rowT, idx) entering bounce `depth` of frame 1, advanced
    through the kernels."""
    dev = tables.device
    R = width * height
    ro, rd = camera_rays(camera, width, height)
    rng = init_rng(torch.arange(R, device=dev), 1)
    _, idx, rowT = cuda_dense.closest_with_row(tables,
                                               ray_stack(ro, rd, T_MAX))
    one = torch.ones(R, device=dev)
    zero = torch.zeros(R, device=dev)
    state = torch.stack([one, *ro, *rd, one, one, one, zero, zero, zero,
                         zero, one, zero, zero, zero, zero, one])
    for d in range(depth):
        out, rng, rays8 = shade_rows.shade(state, rng, rowT, idx,
                                           tables.light_rows, d,
                                           tables.light_count, DEPTH)
        _, idx2, rowT = cuda_dense.closest_with_row(tables, rays8, R)
        state = torch.cat([out[:19], (idx2[:R] >= 0).float()[None]])
        idx = idx2[R:]
    return state, rng, rowT, idx


def check_shade(tables, camera, width, height) -> dict:
    """Kernel 2 against shade_step + next_rays on real cornell bounces."""
    worst = 0.0
    for depth in (0, 4):
        state, rng, rowT, idx = bounce_inputs(tables, camera, width, height,
                                              depth)
        args = (state, rng, rowT, idx, tables.light_rows, depth,
                tables.light_count, DEPTH)
        out_k, rng_k, rays_k = shade_rows.shade(*args)
        out_p, rng_p = shade_rows.shade_step(*args)
        rays_p = shade_rows.next_rays(out_p)
        torch.cuda.synchronize()
        assert torch.equal(rng_k, rng_p), "rng words differ"
        assert torch.equal(rays_k, shade_rows.next_rays(out_k)), \
            "ray stack disagrees with the kernel's own rows"
        o_k, o_p = out_k.cpu().numpy(), out_p.cpu().numpy()
        assert np.isfinite(o_k).all()
        flag_rows = list(shade_rows.FLAG_ROWS)
        f32_rows = [r for r in range(o_k.shape[0]) if r not in flag_rows]
        close = np.isclose(o_k[f32_rows], o_p[f32_rows], rtol=1e-4,
                           atol=1e-5).all(0)
        flags = (o_k[flag_rows] == o_p[flag_rows]).all(0)
        rays_close = np.isclose(rays_k.cpu().numpy(), rays_p.cpu().numpy(),
                                rtol=1e-4, atol=1e-5).all(0).mean()
        err = (float(np.abs(o_k[f32_rows] - o_p[f32_rows])[:, close].max())
               if close.any() else float("inf"))
        worst = max(worst, err)
        print(f"shade depth {depth}: {close.mean():.6f} lanes close, "
              f"{flags.mean():.6f} flags equal, ray stack close "
              f"{rays_close:.6f}, max abs err on close lanes {err:.3e}, "
              f"live {o_k[0].mean():.3f}, nee {o_k[15].mean():.3f}")
        assert close.mean() >= 0.995 and flags.mean() >= 0.995
        assert rays_close >= 0.995
        if depth == 0:
            ms = median_ms(lambda: shade_rows.shade(*args))
            plain_ms = median_ms(
                lambda: shade_rows.next_rays(shade_rows.shade_step(*args)[0]),
                reps=5)
    print(f"shade: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(name="shade_rows", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/shade_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/shade_rows.py:264",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def frames(tables, camera, width, height, n, golden_key):
    """n frames of trace_pixels_dense (jitter 0, spp 1, depth 8): checks
    the golden mean over all n and prints ms/frame and Mrays/s of frames
    2..n (frame 1 also pays the allocator's first requests at this size)."""
    jitter = torch.zeros(2, device=tables.device)
    means, rays = [], []

    def frame(f):
        col, r = trace_pixels_dense(tables, camera, f, jitter, width, height,
                                    1, DEPTH, with_stats=True)
        means.append(col.mean())
        rays.append(r)
        return col

    frame(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(2, n + 1):
        col = frame(f)
    timed = float(torch.stack(rays[1:]).sum())  # synchronises
    seconds = time.perf_counter() - t0
    col = col.cpu().numpy()
    assert col.shape == (width * height, 3) and np.isfinite(col).all()
    mean = float(torch.stack(means).mean())
    golden = GOLDENS[golden_key]
    ok = abs(mean - golden) <= GOLDEN_TOL * golden
    ms = 1e3 * seconds / (n - 1)
    mrays = timed / seconds / 1e6
    print(f"{golden_key} d{DEPTH}: {n} frames, {ms:.3f} ms/frame and "
          f"{mrays:.2f} Mrays/s over frames 2..{n} "
          f"({timed / (n - 1):.0f} rays/frame), mean {mean:.4f} vs golden "
          f"{golden} (+-{GOLDEN_TOL:.0%}) {'ok' if ok else 'FAIL'}")
    assert ok, f"{golden_key}: mean {mean} outside golden {golden}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    assert smi.returncode == 0, smi.stderr
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {torch.cuda.device_count()}); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # --- phase 1: build ---
    path, seconds, log = kernels.build(("-Xptxas", "-v"))
    kernels.library()
    print(f"build: {seconds:.1f} s -> {path}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # --- phase 2: each kernel against its plain version ---
    width, height = 512, 512
    world = NativeWorld("cornell")
    world.update_camera(width, height)
    tables = build_world_tables(world, dev)
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    results = [check_sweep(tables, camera, width, height),
               check_shade(tables, camera, width, height)]

    # --- phase 3: the main path, counting launches ---
    kernels.reset_launches()
    frames(tables, camera, width, height, 32, "cornell_512")
    world.update_camera(1920, 1080)
    cam_hd = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    frames(tables, cam_hd, 1920, 1080, 8, "cornell_1080p")

    r = Renderer("cornell", RenderConfig(width=512, height=512,
                                         max_depth=DEPTH), device="cuda")
    r.render_frame()
    r.present()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = 0.0
    for _ in range(15):
        r.render_frame()
        img = r.present()  # copies to the host: synchronises
        rays += float(r.last_rays)
    seconds = time.perf_counter() - t0
    assert img.shape == (512, 512, 3) and img.dtype == np.uint8
    assert 10 < img.mean() < 245, f"implausible image mean {img.mean()}"
    assert np.isfinite(r.radiance()).all()
    assert r.launches == {"dense_sweep": 16 * (1 + DEPTH),
                          "shade_rows": 16 * DEPTH}, r.launches
    print(f"Renderer cornell 512x512 d{DEPTH}: 16 x (render_frame + "
          f"present), frames 2..16 {1e3 * seconds / 15:.3f} ms/frame, "
          f"{rays / seconds / 1e6:.2f} Mrays/s, image mean {img.mean():.2f}")

    n_frames = 32 + 8 + 16
    counts = dict(kernels.launches)
    want = {"dense_sweep": n_frames * (1 + DEPTH),
            "shade_rows": n_frames * DEPTH}
    assert counts == want, f"launch counts {counts}, expected {want}"
    print(f"launches on the main path ({n_frames} frames): {counts}")

    for res in results:
        res["launches"] = counts[res["name"]]
    print(smi_line)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
