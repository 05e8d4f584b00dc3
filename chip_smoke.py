#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, render.

Run from the repository root with no arguments:

    python3 chip_smoke.py            # add --profile for a torch.profiler
                                     # device-time split of each path

It builds the port's CUDA kernels from `webgpu_raytracer_tpu_torch/csrc/`
(and the shared native scene compiler), then:

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it, and times kernel, plain version and, where
   one exists, the PyTorch library call that computes the same function:
   the sweep and the shade kernel at cornell 512^2; the row fetch on
   cornell's shade table with the 1080p G-buffer's wt_idx and on the light
   rows with a bounce's light pick; the quad fetch on the textured quad's
   level-0 table and its mip with the rows of a 1080p bounce; the
   job-stream path's cull and narrow-phase kernels on the fused bounce-1
   sweep of `spheres` 512^2 (524,288 lanes over 2,009 tiles), the narrow
   phase bit-equal to the sweep kernel walking every tile; the scan path's
   keyed cull and scan kernel on the same sweep (512 ray tiles of 1,024
   lanes), bit-equal to that walk too, with the exact and the cone cull.
   Both narrow-phase kernels are launched twice and must repeat themselves
   bit for bit (their lane queues fill in an order that varies), and the
   tiles and (lane, tile) pairs they report walking must equal the plain
   count.
   Kernel times are many launches between one pair of CUDA events;
2. drives every path of the port with the launch counts set to 0 just
   before it and read just after, and asserts each kernel's exact count:
   - cornell 512^2 d8 x 32 and 1920x1080 d8 x 8 (`trace_pixels_dense`, the
     row-state loop: 1 + 8 sweeps and 8 shades a frame), each mean within
     2% of bench.py's golden;
   - `Renderer("cornell", 512x512, d8)`: `render_frame()` + `present()`
     x 16;
   - the textured quad GLB (bench.py's config 3) at 1920x1080 d8 x 8 through
     `ray_color_dense`, mean within 2% of 0.2739, from a texture decoded
     without PIL and checked to be red and blue;
   - G-buffer-seeded cornell 1920x1080 d8 x 8, mean within 2% of 0.1766,
     frame 1 bit-equal to the traced frame 1;
   - the textured `Renderer` at 512^2 d8, `render_frame(use_gbuffer=True)`
     + `present()` x 8;
   - `spheres` (257,136 triangles) 512^2 d8 x 4 (`trace_pixels_dense`:
     1 + 8 culls and job sweeps and 8 shades a frame, no dense sweep),
     mean within 2% of bench.py's golden, then `Renderer("spheres",
     512x512, d8)`: `render_frame()` + `present()` x 4;
   - `spheres` 512^2 d8 x 4 through `trace_pixels_dense(narrow="scan")`
     (1 + 8 keyed culls and scan sweeps and 8 shades a frame, no job sweep
     and no dense sweep), the same golden, frame 1 bit-equal to the job
     path's, then `Renderer("spheres", narrow="scan")` x 4;
3. prints the card's name and power limit, one JSON line of per-kernel
   results, and last `{"ok": true, "device": {...}}`.

Every check is an assert; there is no fallback. Without CUDA it exits
non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import (cuda_dense, cuda_fetch, cuda_jobs,
                                            cuda_scan, shade_rows)
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (CLUSTER_CHUNK,
                                                         LANE_CHUNK,
                                                         keys_plain,
                                                         lane_terms, pair_ok,
                                                         sort_keyed,
                                                         worklists_plain)
from webgpu_raytracer_tpu_torch.ops.coherence import coherence_sort
from webgpu_raytracer_tpu_torch.ops.dense import (T_MAX, closest_plain,
                                                  jobs_closest_plain,
                                                  jobs_stats_plain,
                                                  ray_stack, rows_plain,
                                                  scan_closest_plain,
                                                  shadow_plain,
                                                  worklist_mask)
from webgpu_raytracer_tpu_torch.ops.tune import M_TILE2, M_TILE3
from webgpu_raytracer_tpu_torch.ops.dense_trace import (
    BASE, EMISSIVE, METAL_ROUGH, NORMAL, bounce_inputs, bounce_rays,
    intersect_and_shade, pinhole_rays, texel_rows, trace_pixels_dense)
from webgpu_raytracer_tpu_torch.ops.fetch import (device_pyramid,
                                                  fetch_quad_plain,
                                                  fetch_rows_plain)
from webgpu_raytracer_tpu_torch.ops.gbuffer import render_gbuffer
from webgpu_raytracer_tpu_torch.ops.rng import init_rng, rand_n
from webgpu_raytracer_tpu_torch.render.worldtris import (SHADE_COLS,
                                                         build_world_tables)
from webgpu_raytracer_tpu_torch.utils.textures import (build_quad_pyramid,
                                                       decode_world_textures)

# bench.py's golden mean radiance (same estimator) and its 2% gate
GOLDENS = {"cornell_512": 0.3040, "cornell_1080p": 0.1766,
           "textured_1080p": 0.2739, "spheres_512": 0.0424}
GOLDEN_TOL = 0.02
DEPTH = 8
KERNEL_LAUNCHES = 200  # per timing, between one pair of CUDA events
PLAIN_LAUNCHES = 20
SMALL = (512, 512)
HD = (1920, 1080)
DEVICE = "cuda"

# The card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
# and f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SWEEP_OPS = 45   # f32 operations per ray x triangle test (dense_sweep.cu)
SHADE_OPS = 300  # f32 operations per lane of one bounce (shade_rows.cu)
CULL_OPS = 25    # f32 operations per lane x cluster test (cluster_cull.cu)
KEYED_CULL_OPS = 30  # the same test with its root, quotient and key
JOB_PLAIN_GROUPS = 256  # lane groups the plain job sweep is held on
JOB_STATS_GROUPS = 32  # lane groups the job kernel's stats are held on
SCAN_PLAIN_TILES = 4  # ray tiles per segment the plain scan path is held on

PNG_SIG = b"\x89PNG\r\n\x1a\n"


def device_ms(fn, launches: int = KERNEL_LAUNCHES, warmup: int = 3) -> float:
    """Device ms per call of fn: `launches` calls between one pair of CUDA
    events, after `warmup` calls."""
    for _ in range(warmup):
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


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: (ms, the bound that decides)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def png_rgb(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> PNG bytes (filter 0 rows, zlib), without PIL."""
    h, w, _ = img.shape

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def textured_quad_glb() -> bytes:
    """tests/glb_fixture.textured_quad_glb without PIL: the same quad and
    the same 8x8 image, left half red and right half blue, as a PNG
    baseColorTexture."""
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = [255, 0, 0]
    img[:, 4:] = [0, 0, 255]
    png = png_rgb(img)
    positions = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)

    def pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
        return b + fill * ((4 - len(b) % 4) % 4)

    blobs = [positions.tobytes(), normals.tobytes(), uvs.tobytes(),
             indices.tobytes(), png]
    offsets = np.cumsum([0] + [len(pad4(b)) for b in blobs[:-1]]).tolist()
    bin_data = b"".join(pad4(b) for b in blobs)
    views = [48, 48, 32, 12, len(png)]
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0.0, 1.0, 0.0]}],
        "buffers": [{"byteLength": len(bin_data)}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": n}
                        for o, n in zip(offsets, views)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "images": [{"bufferView": 4, "mimeType": "image/png"}],
        "textures": [{"source": 0}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.0,
            },
        }],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3,
            "material": 0,
        }]}],
    }
    js = pad4(json.dumps(doc).encode(), b" ")
    total = 12 + 8 + len(js) + 8 + len(bin_data)
    return (struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_data), 0x004E4942) + bin_data)


def sweep_inputs(camera, width, height):
    """The fused per-bounce layout at cornell 512^2: R camera rays (every
    4th with t_max 2.0) then R random rays inside the box (every 5th
    inactive, every 3rd with t_max 1.5), as one (8, 2R) numpy stack."""
    R = width * height
    ro_c, rd_c = pinhole_rays(camera, width, height)
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

    ms = device_ms(lambda: cuda_dense.closest_with_row(tables, rays8, R))
    ms_any = device_ms(lambda: cuda_dense.shadow(tables, rays8))
    plain_ms = device_ms(lambda: rows_plain(
        tables.shade_table, closest_plain(tables, rays8)[1][R:]),
        PLAIN_LAUNCHES)
    plain_any = device_ms(lambda: shadow_plain(tables, rays8),
                          PLAIN_LAUNCHES)
    tw = tables.shade_table.shape[0]
    active = int((rays8[6] > 0).sum())
    nbytes = (rays8.numel() * 4 + 2 * R * 4 * 2 + R * 40 * 4
              + tables.features.numel() * 4 + tw * 40 * 4)
    b_ms, b_by = bound(nbytes, active * tables.valid_count * SWEEP_OPS)
    print(f"sweep closest+rows: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); "
          f"any-hit: kernel {ms_any:.4f} ms, plain {plain_any:.4f} ms")
    return dict(name="dense_sweep", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/dense_sweep.cu",
                replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:57",
                max_abs_err=t_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_shade(tables, camera, width, height) -> dict:
    """Kernel 2 against shade_step + next_rays on real cornell bounces."""
    worst = 0.0
    for depth in (0, 4):
        state, rng, rowT, idx = bounce_inputs(tables, camera, width, height,
                                              depth, DEPTH)
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
            ms = device_ms(lambda: shade_rows.shade(*args))
            plain_ms = device_ms(
                lambda: shade_rows.next_rays(shade_rows.shade_step(*args)[0]),
                PLAIN_LAUNCHES)
            R = width * height
            nbytes = (R * (20 * 4 + 8 + 40 * 4 + 4 + 27 * 4 + 8 + 16 * 4)
                      + tables.light_rows.numel() * 4)
            b_ms, b_by = bound(nbytes, R * SHADE_OPS)
    print(f"shade: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
    return dict(name="shade_rows", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/shade_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/shade_rows.py:264",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_jobs(tables, camera, width, height) -> list[dict]:
    """The job-stream path's kernels on the fused sweep of bounce 1 (2R
    lanes): the cull against its plain version, the narrow phase bit-equal
    to the sweep kernel walking every tile and to its plain version on the
    first JOB_PLAIN_GROUPS groups. Times the coherence sort too."""
    R = width * height
    g = M_TILE3
    spheres = tables.spheres
    ct = spheres.shape[0]
    rays8 = bounce_rays(tables, camera, width, height, 1, DEPTH)
    rays_s, perm = coherence_sort(rays8, spheres, g, R)
    order, counts = cuda_jobs.worklists(spheres, rays_s, g)
    order_p, counts_p = worklists_plain(spheres, rays_s, g)
    torch.cuda.synchronize()
    assert torch.equal(counts, counts_p), "worklist counts differ"
    pos = torch.arange(ct, device=order.device)[None, :] < counts[:, None]
    assert torch.equal(torch.where(pos, order, -1),
                       torch.where(pos, order_p, -1)), "worklists differ"
    live = int((rays_s[6] > 0).sum())
    n_pairs = int(counts.sum())
    G = counts.shape[0]
    busy = counts > 0
    print(f"cull: {2 * R} lanes ({live} live) x {ct} clusters, {G} groups "
          f"of {g}; worklists equal to the plain cull; length mean "
          f"{n_pairs / G:.2f} (over non-empty groups "
          f"{n_pairs / max(int(busy.sum()), 1):.2f}), max "
          f"{int(counts.max())}; {n_pairs} (group, cluster) jobs")

    def jobs(any_hit, stats=False):
        return cuda_jobs.job_sweep(tables, rays_s, perm, order, counts, g,
                                   2 * R, any_hit, R, with_stats=stats)

    t, idx, rows, stats = jobs(False, stats=True)
    occ, stats_any = jobs(True, stats=True)
    t_f, idx_f, rows_f = cuda_dense.full_sweep(tables, rays8, False, R)
    occ_f = cuda_dense.full_sweep(tables, rays8, True)
    torch.cuda.synchronize()
    assert bits_equal(idx, idx_f), "job sweep winners differ"
    assert bits_equal(t, t_f), "job sweep t differs"
    assert bits_equal(rows, rows_f), "job sweep rows differ"
    assert torch.equal(occ, occ_f), "job sweep occlusion differs"
    # The queue's order varies from launch to launch; no output may.
    again = jobs(False)
    assert all(bits_equal(a, b) for a, b in zip(again, (t, idx, rows))), \
        "job sweep differs between two launches"
    assert torch.equal(jobs(True), occ), "job sweep occlusion, two launches"
    for st in (stats, stats_any):
        assert torch.equal(st[:, 2], counts), "stats: worklist lengths"
        assert (st[:, 0] <= st[:, 2]).all() and (st[:, 1] >= st[:, 0]).all()
        assert (st[:, 1] <= g * st[:, 0]).all()
    sub_st = (rays_s[:, :JOB_STATS_GROUPS * g], order[:JOB_STATS_GROUPS],
              counts[:JOB_STATS_GROUPS])
    assert int(sub_st[2].sum()) > 0, "the groups held on stats are empty"
    for any_hit, st in ((False, stats), (True, stats_any)):
        assert torch.equal(jobs_stats_plain(tables, *sub_st, g, any_hit),
                           st[:JOB_STATS_GROUPS].cpu()), "plain job stats"
    hits = float((idx >= 0).float().mean())
    assert 0.05 < hits < 1.0, f"implausible hit fraction {hits}"
    L = JOB_PLAIN_GROUPS * g
    sub = (rays_s[:, :L], order[:JOB_PLAIN_GROUPS],
           counts[:JOB_PLAIN_GROUPS])
    t_p, i_p = jobs_closest_plain(tables, *sub, g)
    lanes = perm[:L].long()
    keep = lanes < 2 * R
    assert bits_equal(i_p[keep], idx[lanes[keep]]), "plain job winners"
    assert bits_equal(t_p[keep], t[lanes[keep]]), "plain job t"
    print(f"job sweep: t, idx, rows bit-equal to dense_sweep over all {ct} "
          f"tiles, occlusion equal; hits {hits:.3f}, occluded "
          f"{float(occ.float().mean()):.3f}; bit-equal to the plain job "
          f"sweep on the first {JOB_PLAIN_GROUPS} groups, stats equal to "
          f"the plain count on the first {JOB_STATS_GROUPS}; two launches "
          f"bit-equal")

    sort_ms = device_ms(lambda: coherence_sort(rays8, spheres, g, R),
                        PLAIN_LAUNCHES)
    cull_ms = device_ms(lambda: cuda_jobs.worklists(spheres, rays_s, g))
    cull_plain_ms = device_ms(lambda: worklists_plain(
        spheres, rays_s[:, :L], g), PLAIN_LAUNCHES)
    job_ms = device_ms(lambda: jobs(False))
    job_any_ms = device_ms(lambda: jobs(True))
    job_plain_ms = device_ms(lambda: jobs_closest_plain(tables, *sub, g), 3)
    path_ms = device_ms(lambda: cuda_dense.closest_with_row(tables, rays8, R),
                        20)
    full_ms = device_ms(lambda: cuda_dense.full_sweep(tables, rays8, False,
                                                      R), 1)
    # Bounds from this run's data. The cull reads the rays and the spheres
    # and writes each group's survivors and count. The job sweep must test
    # each lane only against the tiles whose sphere its segment, up to the
    # hit it found, can touch (the kernel's per-lane skip), and read each
    # tile that some worklist holds once: rays, perm, counts and worklist
    # entries in; t, idx and the extension lanes' rows out, the hits' shade
    # rows in.
    cull_bytes = rays_s.numel() * 4 + ct * 16 + n_pairs * 4 + G * 4
    cb_ms, cb_by = bound(cull_bytes, live * ct * CULL_OPS)
    t_s = torch.where(perm < 2 * R, t[perm.long().clamp(max=2 * R - 1)], 0.0)
    lane_pairs = needed_pairs(spheres, rays_s, t_s)
    tiles_read = int(worklist_mask(order, counts, ct).any(0).sum())
    ext_hits = int((idx[R:] >= 0).sum())
    job_bytes = (2 * R * (32 + 4) + G * 4 + n_pairs * 4
                 + tiles_read * 25 * 128 * 4 + 2 * R * 8 + R * 40 * 4
                 + ext_hits * 40 * 4)
    jb_ms, jb_by = bound(job_bytes, lane_pairs * 128 * SWEEP_OPS)
    print(f"coherence sort (torch sort + gather, {2 * R} lanes): "
          f"{sort_ms:.4f} ms")
    print(f"cull: kernel {cull_ms:.4f} ms, plain {cull_plain_ms:.4f} ms on "
          f"the first {JOB_PLAIN_GROUPS} groups ({L} lanes), bound "
          f"{cb_ms:.4f} ms ({cb_by}, {live} live lanes x {ct} x {CULL_OPS} "
          f"ops, {cull_bytes / 1e6:.1f} MB)")
    print(f"job sweep closest+rows: kernel {job_ms:.4f} ms (any-hit "
          f"{job_any_ms:.4f} ms), plain {job_plain_ms:.4f} ms on the first "
          f"{JOB_PLAIN_GROUPS} groups, bound {jb_ms:.4f} ms ({jb_by}, "
          f"{lane_pairs} (lane, tile) pairs a lane's segment up to its hit "
          f"touches x 128 x {SWEEP_OPS} ops; walked: "
          f"{int(stats[:, 1].sum())} pairs in {int(stats[:, 0].sum())} of "
          f"the {n_pairs} jobs (any-hit {int(stats_any[:, 1].sum())} in "
          f"{int(stats_any[:, 0].sum())}), against {n_pairs * g} pairs in "
          f"the groups' worklists; {tiles_read} tiles read, "
          f"{job_bytes / 1e6:.1f} MB); whole path (sort + cull + sweep) "
          f"{path_ms:.4f} ms; dense_sweep over every tile {full_ms:.4f} ms")
    common = dict(max_abs_err=0.0, library_ms=None)
    return [dict(name="job_sweep", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/job_sweep.cu",
                 replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:991",
                 ms=job_ms, plain_ms=job_plain_ms, bound_ms=jb_ms,
                 bound_by=jb_by, **common),
            dict(name="cluster_cull", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/cluster_cull.cu",
                 replaces="webgpu_raytracer_tpu/ops/cluster_cull.py:26",
                 ms=cull_ms, plain_ms=cull_plain_ms, bound_ms=cb_ms,
                 bound_by=cb_by, **common)]


def check_scan(tables, camera, width, height) -> list[dict]:
    """The scan path's kernels on the fused sweep of bounce 1 (2R lanes, in
    ray tiles of M_TILE2): the keyed cull against its plain version on the
    first SCAN_PLAIN_TILES tiles of each segment (shadow lanes, extension
    lanes); the scan kernel bit-equal to the sweep kernel walking every
    tile, with the exact and with the cone cull's worklists, and to its
    plain version (outputs and per-tile stats) on those first tiles. Times
    the job path again beside the scan path."""
    R = width * height
    m = M_TILE2
    assert R % m == 0
    dev = tables.device
    spheres = tables.spheres
    ct = spheres.shape[0]
    rays8 = bounce_rays(tables, camera, width, height, 1, DEPTH)
    rays_s, perm = coherence_sort(rays8, spheres, m, R)
    T = rays_s.shape[1] // m
    key_map = cuda_scan.cluster_keys(spheres, rays_s, m)
    order, keys, counts = sort_keyed(key_map)
    tiles = (list(range(SCAN_PLAIN_TILES))
             + list(range(R // m, R // m + SCAN_PLAIN_TILES)))
    tiles_t = torch.tensor(tiles, device=dev)
    sub_s = torch.cat([rays_s[:, t * m:(t + 1) * m] for t in tiles], 1)
    key_map_p = keys_plain(spheres, sub_s, m)
    torch.cuda.synchronize()
    assert (counts[tiles_t] > 0).all(), "a checked tile is dead"
    assert torch.equal(key_map[tiles_t] < 3e38, key_map_p < 3e38), \
        "keyed cull survivors differ"
    key_ulps, key_err = 0, 0.0
    if not torch.equal(key_map[tiles_t], key_map_p):
        key_ulps = int((key_map[tiles_t].view(torch.int32).long()
                        - key_map_p.view(torch.int32).long()).abs().max())
        key_err = float((key_map[tiles_t] - key_map_p).abs().max())
    assert key_ulps <= 2, f"keyed cull keys differ by {key_ulps} ulp"
    assert (keys[:, 1:] >= keys[:, :-1]).all(), "keys not ascending"
    live = int((rays_s[6] > 0).sum())
    n_entries = int(counts.sum())
    busy = counts > 0
    n_busy = max(int(busy.sum()), 1)
    print(f"keyed cull: {2 * R} lanes ({live} live) x {ct} clusters, {T} "
          f"tiles of {m} ({int(busy.sum())} non-empty); survivors equal to "
          f"the plain keyed cull on {len(tiles)} tiles, keys "
          f"{'bit-equal' if key_ulps == 0 else f'within {key_ulps} ulp'}; "
          f"worklist length over non-empty tiles mean "
          f"{n_entries / n_busy:.2f}, max {int(counts.max())}; {n_entries} "
          f"(tile, cluster) entries")

    def scan(any_hit, lists=(order, keys, counts), stats=False):
        return cuda_scan.scan_sweep(tables, rays_s, perm, *lists, m, 2 * R,
                                    any_hit, R, with_stats=stats)

    t, idx, rows, stats = scan(False, stats=True)
    occ, stats_any = scan(True, stats=True)
    t_f, idx_f, rows_f = cuda_dense.full_sweep(tables, rays8, False, R)
    occ_f = cuda_dense.full_sweep(tables, rays8, True)
    torch.cuda.synchronize()
    assert bits_equal(idx, idx_f), "scan sweep winners differ"
    assert bits_equal(t, t_f), "scan sweep t differs"
    assert bits_equal(rows, rows_f), "scan sweep rows differ"
    assert torch.equal(occ, occ_f), "scan sweep occlusion differs"
    # The queue's order varies from launch to launch; no output may.
    again = scan(False)
    assert all(bits_equal(a, b) for a, b in zip(again, (t, idx, rows))), \
        "scan sweep differs between two launches"
    assert torch.equal(scan(True), occ), "scan sweep occlusion, two launches"
    for st in (stats, stats_any):
        assert torch.equal(st[:, 2], counts), "stats: worklist lengths"
        assert (st[:, 1] <= st[:, 0]).all() and (st[:, 0] <= st[:, 2]).all()
        assert (st[:, 3] >= st[:, 1]).all() and (st[:, 3] <= m * st[:, 1]).all()
    sub = (sub_s, order[tiles_t], keys[tiles_t], counts[tiles_t])
    t_p, i_p, stats_p = scan_closest_plain(tables, *sub, m, with_stats=True)
    lanes = torch.cat([perm[t * m:(t + 1) * m] for t in tiles]).long()
    keep = lanes < 2 * R
    assert bits_equal(i_p[keep], idx[lanes[keep]]), "plain scan winners"
    assert bits_equal(t_p[keep], t[lanes[keep]]), "plain scan t"
    assert torch.equal(stats_p, stats[tiles_t].cpu()), "plain scan stats"

    cone = cuda_scan.worklists_keyed(spheres, rays_s, m, "cone")
    exact_mask = worklist_mask(order, counts, ct)
    cone_mask = worklist_mask(cone[0], cone[2], ct)
    assert not (exact_mask & ~cone_mask).any(), \
        "the cone cull dropped a survivor of the exact cull"
    t_c, idx_c, rows_c = scan(False, cone)
    occ_c = scan(True, cone)
    torch.cuda.synchronize()
    assert bits_equal(idx_c, idx_f) and bits_equal(t_c, t_f), "cone: hits"
    assert bits_equal(rows_c, rows_f), "cone: rows differ"
    assert torch.equal(occ_c, occ_f), "cone: occlusion differs"
    n_cone = int(cone[2].sum())
    sc, pr = int(stats[:, 0].sum()), int(stats[:, 1].sum())
    sc_a, pr_a = int(stats_any[:, 0].sum()), int(stats_any[:, 1].sum())
    print(f"scan sweep: t, idx, rows bit-equal to dense_sweep over all {ct} "
          f"tiles, occlusion equal ({int((idx >= 0).sum())} of {live} live "
          f"lanes hit), with the exact and with the cone cull "
          f"(cone worklists hold the exact ones: {n_cone} entries, mean "
          f"{n_cone / max(int((cone[2] > 0).sum()), 1):.2f} a non-empty "
          f"tile); bit-equal to the plain scan, stats included, on "
          f"{len(tiles)} tiles; two launches bit-equal; per non-empty tile, "
          f"closest: scanned "
          f"{sc / n_busy:.2f}, processed {pr / n_busy:.2f} of "
          f"{n_entries / n_busy:.2f} entries (max processed "
          f"{int(stats[:, 1].max())}); any-hit: scanned {sc_a / n_busy:.2f}, "
          f"processed {pr_a / n_busy:.2f}")

    g = M_TILE3
    rays_j, perm_j = coherence_sort(rays8, spheres, g, R)
    order_j, counts_j = cuda_jobs.worklists(spheres, rays_j, g)

    def jobs():
        return cuda_jobs.job_sweep(tables, rays_j, perm_j, order_j, counts_j,
                                   g, 2 * R, False, R)

    def path(narrow):
        return cuda_dense.closest_with_row(tables, rays8, R, narrow=narrow)

    cull_ms = device_ms(lambda: cuda_scan.cluster_keys(spheres, rays_s, m))
    cull_plain_ms = device_ms(lambda: keys_plain(spheres, sub_s, m),
                              PLAIN_LAUNCHES)
    sort_ms = device_ms(lambda: sort_keyed(key_map))
    cone_ms = device_ms(lambda: cuda_scan.worklists_keyed(
        spheres, rays_s, m, "cone"), PLAIN_LAUNCHES)
    job_a = device_ms(jobs, 50)
    scan_ms = device_ms(lambda: scan(False))
    scan_any_ms = device_ms(lambda: scan(True))
    job_b = device_ms(jobs, 50)
    scan_cone_ms = device_ms(lambda: scan(False, cone), 50)
    scan_plain_ms = device_ms(lambda: scan_closest_plain(tables, *sub, m),
                              1, warmup=1)
    path_jobs_a = device_ms(lambda: path("jobs"), 20)
    path_ms = device_ms(lambda: path("scan"), 20)
    path_jobs_b = device_ms(lambda: path("jobs"), 20)
    # Bounds from this run's data. The keyed cull reads the rays and the
    # spheres and writes every key. The scan sweep does the job sweep's
    # work, so it has the job sweep's bound: each lane against the tiles
    # whose sphere its segment, up to the hit it found, can touch, each
    # worklisted tile read once; rays, perm, counts, worklist entries and
    # keys in; t, idx and the extension lanes' rows out.
    cull_bytes = rays_s.numel() * 4 + ct * 16 + T * ct * 4
    cb_ms, cb_by = bound(cull_bytes, live * ct * KEYED_CULL_OPS)
    t_s = torch.where(perm < 2 * R, t[perm.long().clamp(max=2 * R - 1)], 0.0)
    lane_pairs = needed_pairs(spheres, rays_s, t_s)
    tiles_read = int(exact_mask.any(0).sum())
    ext_hits = int((idx[R:] >= 0).sum())
    scan_bytes = (2 * R * (32 + 4) + T * 4 + n_entries * 8
                  + tiles_read * 25 * 128 * 4 + 2 * R * 8 + R * 40 * 4
                  + ext_hits * 40 * 4)
    sb_ms, sb_by = bound(scan_bytes, lane_pairs * 128 * SWEEP_OPS)
    print(f"keyed cull: kernel {cull_ms:.4f} ms, plain {cull_plain_ms:.4f} "
          f"ms on {len(tiles)} tiles ({len(tiles) * m} lanes), bound "
          f"{cb_ms:.4f} ms ({cb_by}, {live} live lanes x {ct} x "
          f"{KEYED_CULL_OPS} ops, {cull_bytes / 1e6:.1f} MB); torch.sort of "
          f"the ({T}, {ct}) keys {sort_ms:.4f} ms; cone cull (plain torch, "
          f"sort included) {cone_ms:.4f} ms")
    print(f"scan sweep closest+rows: kernel {scan_ms:.4f} ms (any-hit "
          f"{scan_any_ms:.4f} ms; on the cone cull's worklists "
          f"{scan_cone_ms:.4f} ms), plain {scan_plain_ms:.4f} ms on "
          f"{len(tiles)} tiles, bound {sb_ms:.4f} ms ({sb_by}, {lane_pairs} "
          f"(lane, tile) pairs a lane's segment up to its hit touches x 128 "
          f"x {SWEEP_OPS} ops; walked: {int(stats[:, 3].sum())} pairs "
          f"(any-hit {int(stats_any[:, 3].sum())}), against {pr * m} in the "
          f"processed entries and {n_entries * m} in the worklists; "
          f"{tiles_read} tiles read, "
          f"{scan_bytes / 1e6:.1f} MB); job sweep in the same call "
          f"{job_a:.4f} / {job_b:.4f} ms (before / after); whole path (sort "
          f"+ cull + sweep) scan {path_ms:.4f} ms, jobs {path_jobs_a:.4f} / "
          f"{path_jobs_b:.4f} ms")
    return [dict(name="scan_sweep", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/scan_sweep.cu",
                 replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:323",
                 max_abs_err=0.0, ms=scan_ms, plain_ms=scan_plain_ms,
                 bound_ms=sb_ms, bound_by=sb_by, library_ms=None),
            dict(name="cluster_cull_keyed", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/cluster_cull.cu",
                 replaces="webgpu_raytracer_tpu/ops/cluster_cull.py:26",
                 max_abs_err=key_err, ms=cull_ms, plain_ms=cull_plain_ms,
                 bound_ms=cb_ms, bound_by=cb_by, library_ms=None)]


def needed_pairs(spheres, rays_s, t_end) -> int:
    """(lane, tile) pairs of a sorted stack whose segment (T_MIN, min(t_clip,
    t_end)) can touch the tile's sphere (the cull's test, lane by lane)."""
    dd, t_clip = lane_terms(rays_s, spheres)
    t_clip = torch.minimum(t_clip, t_end)
    n = torch.zeros((), dtype=torch.int64, device=rays_s.device)
    for l0 in range(0, rays_s.shape[1], LANE_CHUNK):
        lanes = slice(l0, l0 + LANE_CHUNK)
        for c0 in range(0, spheres.shape[0], CLUSTER_CHUNK):
            n += pair_ok(rays_s[:, lanes], dd[lanes], t_clip[lanes],
                         spheres[c0:c0 + CLUSTER_CHUNK]).sum()
    return int(n)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two 32-bit tensors (f32 compared as int32 words)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def time_fetch(label, kernel, plain, library, nbytes) -> dict:
    ms = device_ms(kernel)
    plain_ms = device_ms(plain)
    library_ms = device_ms(library)
    b_ms, b_by = bound(nbytes)
    print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)


def check_fetch_rows(cases) -> dict:
    """Kernel 3 against its plain version on (label, table, idx) cases;
    the first case's numbers go to the JSON line."""
    results = []
    for label, table, idx in cases:
        out_k = cuda_fetch.fetch_rows_t(table, idx)
        out_p = fetch_rows_plain(table, idx)
        torch.cuda.synchronize()
        assert bits_equal(out_k, out_p), f"{label}: rows differ"
        n, k = table.shape
        r = idx.shape[0]
        clipped = idx.clamp(0, n - 1)
        print(f"fetch_rows {label}: N {n}, K {k}, R {r}, bit-equal")
        results.append(time_fetch(
            f"fetch_rows {label}",
            lambda: cuda_fetch.fetch_rows_t(table, idx),
            lambda: fetch_rows_plain(table, idx),
            lambda: table.index_select(0, clipped).T.contiguous(),
            r * 4 + k * r * 4 + n * k * 4))
    return dict(name="fetch_rows", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/fetch_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:1381",
                max_abs_err=0.0, **results[0])


def check_fetch_quad(cases) -> dict:
    """Kernel 4 against its plain version on (label, flat, rows) cases;
    the first case's numbers go to the JSON line."""
    results = []
    for label, flat, rows in cases:
        out_k = cuda_fetch.fetch_quad(flat, rows)
        out_p = fetch_quad_plain(flat, rows)
        torch.cuda.synchronize()
        assert bits_equal(out_k, out_p), f"{label}: words differ"
        n, r = flat.shape[0], rows.shape[0]
        print(f"fetch_quad {label}: N {n}, R {r}, bit-equal")
        results.append(time_fetch(
            f"fetch_quad {label}",
            lambda: cuda_fetch.fetch_quad(flat, rows),
            lambda: fetch_quad_plain(flat, rows),
            lambda: flat.index_select(0, rows),
            r * 4 + r * 16 + n * 16))
    return dict(name="fetch_quad", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/fetch_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:1438",
                max_abs_err=0.0, **results[0])


def frames(tables, camera, width, height, n, golden_key, textures=None,
           seeded=False, narrow="jobs"):
    """n frames of trace_pixels_dense (jitter 0, spp 1, depth 8), traced or
    seeded from a G-buffer rendered each frame: checks the golden mean
    over all n and prints ms/frame and Mrays/s of frames 2..n (frame 1 also
    pays the allocator's first requests at this size). `narrow` picks a
    multi-tile scene's narrow phase. Returns frame 1's radiance on the
    host."""
    jitter = torch.zeros(2, device=tables.device)
    means, rays, first = [], [], []

    def frame(f):
        seed, gb_rays = None, 0.0
        if seeded:
            gb = render_gbuffer(tables, textures, camera, width, height,
                                jitter=jitter, narrow=narrow)
            seed = gb.wt_idx.reshape(-1)
            gb_rays = float(width * height)
        col, r = trace_pixels_dense(tables, camera, f, jitter, width, height,
                                    1, DEPTH, with_stats=True,
                                    textures=textures, seed_wt_idx=seed,
                                    narrow=narrow)
        means.append(col.mean())
        rays.append(r + gb_rays)
        return col

    first.append(frame(1).cpu())
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
    tag = (" seeded" if seeded else "") + (
        f" narrow={narrow}" if narrow != "jobs" else "")
    print(f"{golden_key}{tag} d{DEPTH}: {n} frames, "
          f"{ms:.3f} ms/frame and {mrays:.2f} Mrays/s over frames 2..{n} "
          f"({timed / (n - 1):.0f} rays/frame), mean {mean:.4f} vs golden "
          f"{golden} (+-{GOLDEN_TOL:.0%}) {'ok' if ok else 'FAIL'}")
    assert ok, f"{golden_key}: mean {mean} outside golden {golden}"
    return first[0]


def renderer_frames(r: Renderer, n: int, label: str, per_frame: dict,
                    use_gbuffer=False):
    """n x (render_frame + present) through the user's entry points; the
    Renderer's own launch counts must be n x per_frame."""
    r.render_frame(use_gbuffer=use_gbuffer)
    r.present()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = 0.0
    for _ in range(n - 1):
        r.render_frame(use_gbuffer=use_gbuffer)
        img = r.present()  # copies to the host: synchronises
        rays += float(r.last_rays)
    seconds = time.perf_counter() - t0
    assert img.shape == (r.height, r.width, 3) and img.dtype == np.uint8
    assert 10 < img.mean() < 245, f"implausible image mean {img.mean()}"
    assert np.isfinite(r.radiance()).all()
    want = {k: n * v for k, v in per_frame.items()}
    assert r.launches == want, f"Renderer launches {r.launches}, not {want}"
    print(f"Renderer {label}: {n} x (render_frame + present), frames "
          f"2..{n} {1e3 * seconds / (n - 1):.3f} ms/frame, "
          f"{rays / seconds / 1e6:.2f} Mrays/s, image mean {img.mean():.2f}")


def sweeps(n: int, multi_tile: bool, narrow: str = "jobs") -> dict:
    """n sweeps: a dense sweep each on a single-tile scene; on a multi-tile
    one a cull and a job sweep each, or with narrow="scan" a keyed cull and
    a scan sweep each."""
    jobs = n if multi_tile and narrow == "jobs" else 0
    scan = n if multi_tile and narrow == "scan" else 0
    return {"dense_sweep": 0 if multi_tile else n, "cluster_cull": jobs,
            "job_sweep": jobs, "cluster_cull_keyed": scan, "scan_sweep": scan}


def rows_launches(seeded: bool, multi_tile: bool = False,
                  narrow: str = "jobs") -> dict:
    """Per frame of the row-state loop (untextured scenes): traced, one
    primary sweep; seeded, one G-buffer sweep and one seed-row fetch; then
    per bounce one shade and one fused sweep."""
    return {**sweeps(1 + DEPTH, multi_tile, narrow), "shade_rows": DEPTH,
            "fetch_rows": int(seeded), "fetch_quad": 0}


def textured_launches(tables, seeded: bool) -> dict:
    """Per frame of ray_color_dense (textured scenes). Sweeps: the primary
    (or G-buffer) sweep, DEPTH - 1 fused sweeps and the last bounce's
    shadow query. Row fetches: the light rows of every bounce, and the seed
    rows when seeded. Quad fetches: one per bound base / normal slot at
    every shaded hit (primary or G-buffer + seed, then DEPTH - 1 extension
    hits), and one per bound metal-rough / emissive slot and per textured
    light table at every bounce."""
    s = tables.tex_slots
    per_hit = int(s[BASE]) + int(s[NORMAL])
    per_bounce = int(s[METAL_ROUGH]) + int(s[EMISSIVE]) + int(tables.light_tex)
    return {**sweeps(1 + DEPTH, cuda_dense.multi_tile(tables)),
            "shade_rows": 0, "fetch_rows": DEPTH + int(seeded),
            "fetch_quad": per_hit * (DEPTH + int(seeded))
            + per_bounce * DEPTH}


def drive(label: str, n_frames: int, per_frame: dict, fn, totals: dict):
    """Run one path with the launch counts zeroed just before it; assert
    its exact counts and add them to the totals."""
    kernels.reset_launches()
    fn()
    counts = dict(kernels.launches)
    want = {k: n_frames * v for k, v in per_frame.items()}
    assert counts == want, f"{label}: launches {counts}, expected {want}"
    print(f"launches, {label} ({n_frames} frames): {counts}")
    for k, v in counts.items():
        totals[k] += v


def profile_paths(paths) -> None:
    """torch.profiler over 2 frames of each path: device time by kernel and
    the device's busy share of the same 2 frames' wall time, taken inside
    the profiled window (the tracer's start and stop fall outside it; its
    cost per launch does not, so the share is a floor). Only the kernels'
    own events count (a CPU op's device time repeats its kernels')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # The first profile of a process also pays the tracer's start-up:
    # spend it on a warm-up, outside the measured windows.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        paths[0][1]()
        torch.cuda.synchronize()
    for label, fn in paths:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        events = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy = sum(t for _, t, _ in events)
        launches = sum(c for _, _, c in events)
        print(f"profile {label}: device busy {busy / 2e3:.3f} ms/frame in "
              f"{launches / 2:.0f} kernel launches/frame, busy share of "
              f"profiled wall {busy / wall_us:.3f} ({wall_us / 2e3:.3f} "
              f"ms/frame profiled)")
        for key, t, count in sorted(events, key=lambda e: -e[1])[:8]:
            print(f"  {t / 2e3:9.3f} ms/frame  {count / 2:7.1f} calls/frame"
                  f"  {key[:70]}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
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

    # --- scenes ---
    width, height = SMALL
    hd = HD
    world = NativeWorld("cornell")
    world.update_camera(width, height)
    tables = build_world_tables(world, dev)
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    world.update_camera(*hd)
    cam_hd = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)

    glb = textured_quad_glb()
    tq_world = NativeWorld("viewer", glb_data=glb)
    tq_world.update_camera(*hd)
    tq_tables = build_world_tables(tq_world, dev)
    tq_cam = torch.from_numpy(np.asarray(tq_world.camera(),
                                         np.float32)).to(dev)
    decoded = decode_world_textures(tq_world)
    assert decoded is not None and decoded.shape == (1, 1024, 1024, 3)
    # A decode that failed would fill 0.8 grey: the quad must be red on
    # its left and blue on its right.
    assert np.array_equal(decoded[0, :, :448], np.broadcast_to(
        np.float32([1, 0, 0]), (1024, 448, 3))), "left half is not red"
    assert np.array_equal(decoded[0, :, 576:], np.broadcast_to(
        np.float32([0, 0, 1]), (1024, 448, 3))), "right half is not blue"
    tq_tex = device_pyramid(build_quad_pyramid(decoded), dev)
    assert tq_tex[0].shape == (1, 1024, 1024)
    assert tq_tex[1].shape == (1, 128, 128)
    assert tq_tables.tex_slots == (True, False, False, False)
    assert not tq_tables.light_tex
    print(f"textured quad: {tq_tables.valid_count} world tris (padded "
          f"{tq_tables.shade_table.shape[0]}), {tq_tables.light_count} "
          f"lights, texture decoded red/blue, level 0 "
          f"{tuple(tq_tex[0].flat.shape)}, mip {tuple(tq_tex[1].flat.shape)}")

    sp_world = NativeWorld("spheres")
    sp_world.update_camera(width, height)
    sp_tables = build_world_tables(sp_world, dev)
    sp_cam = torch.from_numpy(np.asarray(sp_world.camera(),
                                         np.float32)).to(dev)
    assert cuda_dense.multi_tile(sp_tables)
    print(f"spheres: {sp_tables.valid_count} world tris (padded "
          f"{sp_tables.shade_table.shape[0]}, {sp_tables.spheres.shape[0]} "
          f"tiles), {sp_tables.light_count} lights")

    # --- phase 2: each kernel against its plain version ---
    results = [check_sweep(tables, camera, width, height),
               check_shade(tables, camera, width, height)]

    R_hd = hd[0] * hd[1]
    gb_hd = render_gbuffer(tables, None, cam_hd, *hd)
    wt_idx = gb_hd.wt_idx.reshape(-1)
    lc = tq_tables.light_count
    rng = init_rng(torch.arange(R_hd, device=dev), 1)
    rng, _ = rand_n(rng, 2)  # the lens sample
    _, (r0,) = rand_n(rng, 1)  # bounce 0's light pick draw
    pick = torch.clamp((r0 * float(max(lc, 1))).to(torch.int32), 0,
                       max(lc - 1, 0))
    results.append(check_fetch_rows([
        ("cornell shade table, 1080p G-buffer wt_idx", tables.shade_table,
         wt_idx),
        ("textured quad light rows, bounce-0 light pick",
         tq_tables.light_rows, pick)]))

    ro, rd = pinhole_rays(tq_cam, *hd)
    hit = intersect_and_shade(tq_tables, tq_tex, ro, rd)
    base = torch.where(hit.wt >= 0,
                       hit.rowT[SHADE_COLS["tex"][0]].to(torch.int32), -1)
    rows0 = texel_rows(tq_tex[0], base, hit.tex_u, hit.tex_v)[0]
    rows1 = texel_rows(tq_tex[1], base, hit.tex_u, hit.tex_v)[0]
    results.append(check_fetch_quad([
        ("mip 128^2, 1080p bounce rows", tq_tex[1].flat, rows1),
        ("level 0 1024^2, 1080p bounce rows", tq_tex[0].flat, rows0)]))

    results += check_jobs(sp_tables, sp_cam, width, height)
    results += check_scan(sp_tables, sp_cam, width, height)

    # --- phase 3: every path, counting launches ---
    totals = {k: 0 for k in kernels.launches}
    traced_hd = []
    drive("cornell 512^2 traced", 32, rows_launches(False),
          lambda: frames(tables, camera, width, height, 32, "cornell_512"),
          totals)
    drive("cornell 1080p traced", 8, rows_launches(False),
          lambda: traced_hd.append(frames(tables, cam_hd, *hd, 8,
                                          "cornell_1080p")), totals)

    r = Renderer("cornell", RenderConfig(width=width, height=height,
                                         max_depth=DEPTH), device=dev)
    drive("Renderer cornell 512^2", 16, rows_launches(False),
          lambda: renderer_frames(r, 16, f"cornell {width}x{height} "
                                  f"d{DEPTH}", rows_launches(False)),
          totals)

    drive("textured quad 1080p traced", 8,
          textured_launches(tq_tables, False),
          lambda: frames(tq_tables, tq_cam, *hd, 8, "textured_1080p",
                         textures=tq_tex), totals)

    seeded_hd = []
    drive("cornell 1080p G-buffer seeded", 8, rows_launches(True),
          lambda: seeded_hd.append(frames(tables, cam_hd, *hd, 8,
                                          "cornell_1080p", seeded=True)),
          totals)
    assert torch.equal(seeded_hd[0], traced_hd[0]), \
        "seeded frame 1 differs from the traced frame 1"
    print("cornell 1080p: seeded frame 1 bit-equal to the traced frame 1")

    rt = Renderer("viewer", RenderConfig(width=width, height=height,
                                         max_depth=DEPTH),
                  glb_data=glb, device=dev)
    assert rt.textures is not None and rt.textures[1].shape == (1, 128, 128)
    drive("Renderer textured quad 512^2 G-buffer seeded", 8,
          textured_launches(rt.tables, True),
          lambda: renderer_frames(rt, 8, f"textured quad {width}x{height} "
                                  f"d{DEPTH} use_gbuffer=True",
                                  textured_launches(rt.tables, True),
                                  use_gbuffer=True),
          totals)
    jobs_sp = []
    drive("spheres 512^2 traced", 4, rows_launches(False, True),
          lambda: jobs_sp.append(frames(sp_tables, sp_cam, width, height, 4,
                                        "spheres_512")), totals)
    rs = Renderer("spheres", RenderConfig(width=width, height=height,
                                          max_depth=DEPTH), device=dev)
    drive("Renderer spheres 512^2", 4, rows_launches(False, True),
          lambda: renderer_frames(rs, 4, f"spheres {width}x{height} "
                                  f"d{DEPTH}", rows_launches(False, True)),
          totals)
    scan_launches = rows_launches(False, True, "scan")
    assert scan_launches == {
        "dense_sweep": 0, "cluster_cull": 0, "job_sweep": 0,
        "cluster_cull_keyed": 9, "scan_sweep": 9, "shade_rows": 8,
        "fetch_rows": 0, "fetch_quad": 0}
    scan_sp = []
    drive("spheres 512^2 traced narrow=scan", 4, scan_launches,
          lambda: scan_sp.append(frames(sp_tables, sp_cam, width, height, 4,
                                        "spheres_512", narrow="scan")),
          totals)
    assert bits_equal(scan_sp[0], jobs_sp[0]), \
        "spheres: the scan path's frame 1 differs from the job path's"
    print("spheres 512^2: narrow=scan frame 1 bit-equal to the narrow=jobs "
          "frame 1")
    rsc = Renderer("spheres", RenderConfig(width=width, height=height,
                                           max_depth=DEPTH), device=dev,
                   narrow="scan")
    drive("Renderer spheres 512^2 narrow=scan", 4, scan_launches,
          lambda: renderer_frames(rsc, 4, f"spheres {width}x{height} "
                                  f"d{DEPTH} narrow=scan", scan_launches),
          totals)
    print(f"launches on the main paths (all of the above): {totals}")

    if "--profile" in argv:
        jit0 = torch.zeros(2, device=dev)
        profile_paths([
            ("spheres 512^2 d8", lambda: trace_pixels_dense(
                sp_tables, sp_cam, 1, jit0, width, height, 1, DEPTH)),
            ("spheres 512^2 d8 narrow=scan", lambda: trace_pixels_dense(
                sp_tables, sp_cam, 1, jit0, width, height, 1, DEPTH,
                narrow="scan")),
            ("textured quad 1080p d8", lambda: trace_pixels_dense(
                tq_tables, tq_cam, 1, jit0, *hd, 1, DEPTH, textures=tq_tex)),
            ("cornell 1080p d8 seeded", lambda: trace_pixels_dense(
                tables, cam_hd, 1, jit0, *hd, 1, DEPTH,
                seed_wt_idx=render_gbuffer(tables, None, cam_hd, *hd)
                .wt_idx.reshape(-1))),
            ("cornell 1080p d8 traced", lambda: trace_pixels_dense(
                tables, cam_hd, 1, jit0, *hd, 1, DEPTH)),
        ])

    for res in results:
        res["launches"] = totals[res["name"]]
        assert res["launches"] > 0, f"{res['name']} never ran on a path"
    print(smi_line)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
