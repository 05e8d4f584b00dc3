#!/usr/bin/env python3
"""Each CUDA kernel of the PyTorch port alone on one card: build, hold to
its plain version, time beside its bound.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

This is the per-kernel yardstick. Frames end to end are measured by
`portbench/` (BENCHMARK.json), and every path of the port (launch counts,
goldens, captured steps, sharded steps, recorder, checkpoint, bridge,
farm, CLI) is held on the card at small sizes by `python -m pytest
tests/test_torch_cuda.py -m cuda`; phase 3 below drives one frame of each
path at the sizes the kernels are timed at.

1. Builds the port's kernels from `webgpu_raytracer_tpu_torch/csrc/` (and
   the shared native scene compiler) and prints ptxas' registers, spills
   and entry functions.
2. Holds each kernel against its plain PyTorch version at the shapes its
   main path gives it, and times kernel, plain version and, where one
   exists, the PyTorch library call that computes the same function:
   - the sweep (`dense_sweep.cu`) at cornell 512^2, bit-equal to its plain
     versions (t, idx, rows from lanes 0, R and 2R, occlusion, from two
     launches each) on a synthetic fused stack and on the real bounce-1
     stack, timed with rows, without rows and any-hit on both;
   - the shade kernel's white-texel instantiation at cornell 512^2
     bounces 0 and 4, and its textured one on the textured quad's 1080p
     bounces 0 and 4, the formats scene's (four layers), the formats scene
     with a fifth layer (so level 1 is level 0) and a quad light with a
     textured base colour (NEE reads the light's texels), timed beside its
     byte bound and beside the white-texel kernel at the same lane count;
   - the row fetch on cornell's shade table with the 1080p G-buffer's
     wt_idx and on the light rows with a bounce's light pick; the quad
     fetch on the textured quad's level 0 and mip with the rows of a 1080p
     bounce, and on the formats scene's four-layer level 0 and mip with
     the rows of a 1080p primary hit, one layer a lane in turn;
   - the job-stream path's cull and job sweep on the fused bounce-1 sweep
     of `spheres` 512^2 (524,288 lanes over 2,009 tiles), the job sweep
     bit-equal to the sweep kernel walking every tile; the scan path's
     keyed cull and scan sweep on the same sweep (512 ray tiles of 1,024
     lanes), bit-equal to that walk too, with the exact and the cone cull.
     Both culls are held to their plain versions on all 524,288 lanes
     (counts, survivors in ascending id, keys bit for bit), and again on a
     stack whose first group is half dead and on one that is all dead.
     Culls and narrow-phase kernels are launched twice and must repeat
     themselves bit for bit (the culls' warps merge through shared-memory
     atomics, the sweeps' lane queues fill in an order that varies), and
     the tiles and (lane, tile) pairs the sweeps report walking must equal
     the plain count;
   - the BVH walk (`bvh_walk.cu`), closest and any-hit, bit-equal to its
     plain walk on the same tensors (t, tri, inst, the occluded flag, the
     nodes and triangles each lane visited), twice, on cornell's and
     `spheres`' 512^2 primaries and bounce-1 rays, and on the primaries
     with every 3rd lane given NaN or inf in o, d or t_max (the kernel's
     exact slab test beside its fast one), over the scene's `WalkPack`;
   - the BVH bounce (`bvh_shade.cu`, over the scene's `ShadePack`) against
     `bvh_shade_step` on cornell, the textured quad, the textured light
     and `spheres` at 512^2 and 1920x1080, bounces 0 and 4: rng words
     equal, flags equal on every lane, values within rtol 1e-4
     (near-mirror GGX lanes 5e-2); its back-to-back graph time
     cross-checked against the profiler's own device time a launch, and
     its wrapper's host us split into checks, allocations, context, stream
     and the ctypes launch;
   - how often the plain sampler's f64 emulation of a fused multiply-add
     rounds otherwise than a true f32 one (`fma_ties`);
   - the present pass (`present.cu`, two launches) against the plain
     `postprocess` at 720x480 and 1920x1080, image and history bit for
     bit (frames 1 and 17, with and without the resample), timed on the
     frame-17 graph's path beside its byte bound and the plain chain, the
     chain also graph-timed (`plain_graph_ms`, what the present graph
     replayed before this kernel).
   Each kernel's time is `kernel_ms`: 200 calls of its wrapper captured in
   one CUDA graph and replayed between a pair of CUDA events, so the host's
   cost of the calls is not in it, each call after a 256 MB read that
   empties the L2 (the graph of the reads alone subtracted), so a call
   moves its bytes through memory as the bound counts them; beside it the
   same calls back to back (L2 warm), the host-paced time of the calls
   made from Python (`device_ms`, the slower of device and host) and the
   wrapper's host us a call. Plain versions are host-paced.
3. Drives one frame (frame 1, jitter 0, spp 1, depth 8) of every path,
   and its present (`present_step`, two launches), the launch counts
   zeroed just before it and asserted exactly: cornell
   traced at 512^2 and 1080p, and seeded from the G-buffer at 1080p,
   bit-equal to the traced frame; the textured quad traced at 1080p and
   seeded at 512^2; the formats scene traced and seeded at 1080p, each
   frame bit-equal to its twin's (the port's decodes as 8-bit PNGs);
   `spheres` 512^2 on the job path and the scan path, bit-equal; the BVH
   path on cornell and `spheres` at 512^2, cornell's BVH frame agreeing
   with the dense one on 98% of the lanes (1e-3); the tile, sample and
   2-D sharded steps, eager, on a NCCL world of one on both backends at
   cornell 512^2, the tile step bit-equal to the frame and the others
   within 2e-5 of it. Each kernel row's `launches` is its launches on
   these frames (the textured instantiation's shades, and the formats
   scene's quad fetches, counted apart).
4. Prints the card's name and power limit, one JSON line of per-kernel
   results (`{"kernels": [...]}`), and last `{"ok": true, "device":
   {...}}`.

Every check is an assert; there is no fallback. Without CUDA it exits
non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

from webgpu_raytracer_tpu_torch import NativeWorld
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import (bvh_shade, cuda_dense, cuda_fetch,
                                            cuda_jobs, cuda_present, cuda_scan,
                                            intersect, shade_rows)
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (CLUSTER_CHUNK,
                                                         LANE_CHUNK,
                                                         keys_plain,
                                                         lane_terms, pair_ok,
                                                         sort_keyed,
                                                         worklists_plain)
from webgpu_raytracer_tpu_torch.ops.coherence import box6, coherence_sort
from webgpu_raytracer_tpu_torch.ops.dense import (T_MAX, closest_plain,
                                                  jobs_closest_plain,
                                                  jobs_stats_plain,
                                                  ray_stack, rows_plain,
                                                  scan_closest_plain,
                                                  shadow_plain,
                                                  worklist_mask)
from webgpu_raytracer_tpu_torch.ops import tune
from webgpu_raytracer_tpu_torch.ops.api import get_tracer
from webgpu_raytracer_tpu_torch.ops.tune import M_TILE2, M_TILE3
from webgpu_raytracer_tpu_torch.ops.dense_trace import (
    BASE, EMISSIVE, METAL_ROUGH, NORMAL, bounce_inputs, bounce_rays,
    intersect_and_shade, pinhole_rays, texel_rows, trace_pixels_dense)
from webgpu_raytracer_tpu_torch.ops.fetch import (fetch_quad_plain,
                                                  fetch_rows_plain)
from webgpu_raytracer_tpu_torch.ops.gbuffer import render_gbuffer
from webgpu_raytracer_tpu_torch.ops.intersect import T_MIN
from webgpu_raytracer_tpu_torch.ops.postprocess import postprocess
from webgpu_raytracer_tpu_torch.ops.rng import init_rng, rand_n
from webgpu_raytracer_tpu_torch.ops.trace import (accumulate, load_hit,
                                                  trace_pixels)
from webgpu_raytracer_tpu_torch.parallel import sharding
from webgpu_raytracer_tpu_torch.render.renderer import (EagerSteps,
                                                        present_step)
from webgpu_raytracer_tpu_torch.render.resources import build_device_scene
from webgpu_raytracer_tpu_torch.render.worldtris import (SHADE_COLS,
                                                         build_world_tables)

from tests.torch_scenes import (DEPTH, PRESENT_JITTERS, bits_equal,
                                bvh_bounce_inputs, bvh_scene, fma_rounding,
                                formats_scene_glb, hold_bvh_shade,
                                hold_present, max_abs_diff, poison_lanes,
                                present_inputs, shade_kw, textured_light_glb,
                                textured_quad_glb, textured_scene,
                                walk_bit_equal)

KERNEL_LAUNCHES = 200  # per timing, between one pair of CUDA events
PLAIN_LAUNCHES = 20
SMALL = (512, 512)
HD = (1920, 1080)
DEVICE = "cuda"

# The card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
# and f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The same peak counts a fused multiply-add as two operations. A kernel
# that rounds every product and sum on its own (the culls, for bit equality
# with their plain versions) does one operation an instruction: its floor.
F32_ROUNDED_OPS_PER_S = F32_OPS_PER_S / 2
SWEEP_OPS = 45   # f32 operations per ray x triangle test (dense_sweep.cu)
SHADE_OPS = 300  # f32 operations per lane of one bounce (shade_rows.cu)
# The textured instantiation adds the texture coordinates' separately
# rounded barycentrics (a lane) and one bilinear sample (a quad read).
TEXCOORD_OPS = 48
TEXEL_OPS = 52
CULL_OPS = 25    # f32 operations per lane x cluster test (cluster_cull.cu)
KEYED_CULL_OPS = 30  # the same test with its root, quotient and key
CULL_EDGE_GROUPS = 64  # lane groups of the culls' dead-lane stacks
JOB_PLAIN_GROUPS = 256  # lane groups the plain job sweep is held on
JOB_STATS_GROUPS = 32  # one-chunk groups the job kernel's stats are held on
SCAN_PLAIN_TILES = 4  # ray tiles per segment the plain scan path is held on
BVH_NODE_OPS = 25  # f32 operations of one node's slab test (bvh_walk.cu)
# f32 operations of one Moller-Trumbore test on the packed (p0, e1, e2):
# bvh_walk.cu's tri_hit. The walk's first version also formed e1 and e2 (6
# more, BVH_TRI_OPS_UNPACKED); its bound is printed beside this one.
BVH_TRI_OPS = 55
BVH_TRI_OPS_UNPACKED = 61
# f32 operations of one found lane's BVH bounce (bvh_shade.cu: load_hit,
# the hit's light pdf, the light sample, one BSDF value and pdf, one
# sample), each a separately rounded instruction (the file is built with
# --fmad=false), sin and cos not counted.
BVH_SHADE_OPS = 650
# The present pass (present.cu) a pixel: bytes (the accumulator 16 read,
# the history 12 read and 12 written, the image 3; the clean scratch 16
# written and 16 read) and separately rounded f32 operations (9 bilateral
# taps of ~20, TAA, two ACES, sharpen; expf and powf not counted).
PRESENT_BYTES = 16 + 12 + 12 + 3 + 2 * 16
PRESENT_OPS = 300
PRESENT_SIZE = (720, 480)  # the interactive cells' image


def host_paced(fn, launches: int = KERNEL_LAUNCHES,
               warmup: int = 3) -> tuple[float, float]:
    """(ms a call, host us a call) of `launches` calls of fn made from the
    host between one pair of CUDA events, after `warmup` calls. The ms is
    the slower of the device's work and the host's pace of enqueueing it;
    the host us is the host clock over the same calls, with no synchronise
    inside (the wrapper's own cost, its launch included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / launches
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches, host_us


def device_ms(fn, launches: int = KERNEL_LAUNCHES, warmup: int = 3) -> float:
    """Host-paced ms a call of fn (`host_paced`): the yardstick of plain
    versions and of paths that synchronise."""
    return host_paced(fn, launches, warmup)[0]


L2_FLUSH_BYTES = 256 << 20  # a read of five times the H100's 50 MB L2
_FLUSH = []  # the flush buffer, made at the first kernel_ms


def graph_ms(body, reps: int = 3) -> float:
    """Device ms of body() captured once in a CUDA graph: the median of
    `reps` replays, each between a pair of CUDA events, after one replay to
    warm up. A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    graph.reset()
    return sorted(times)[reps // 2]


def kernel_ms(fn, launches: int = KERNEL_LAUNCHES, warmup: int = 3,
              flush: bool = True) -> float:
    """Device ms a call of fn without the host's cost: `launches` calls
    captured in one CUDA graph (every wrapper launches on torch's current
    stream, `kernels.stream`, so the capture holds its launches). What the
    calls run on the device counts: the kernel, and any torch work of the
    wrapper (none of the port's kernel wrappers has any). A capture that
    fails raises; there is no host-paced fallback.

    With flush (the kernels' yardstick) each call follows a read of
    L2_FLUSH_BYTES, which evicts the last call's inputs and writes its
    outputs back, so a call reads and writes memory as the bound counts:
    the graph of (read, call) pairs less the graph of the reads alone.
    Without it the calls run back to back, and a working set that fits the
    L2 stays there: faster than the bytes allow, a share of the bound over
    1 says so."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if not flush:
        return graph_ms(lambda: [fn() for _ in range(launches)]) / launches
    if not _FLUSH:
        _FLUSH.append(torch.zeros(L2_FLUSH_BYTES // 4, device="cuda"))
    buf = _FLUSH[0]

    def pairs():
        for _ in range(launches):
            buf.sum()
            fn()

    def reads():
        for _ in range(launches):
            buf.sum()

    return (graph_ms(pairs) - graph_ms(reads)) / launches


def kernel_times(fn, launches: int = KERNEL_LAUNCHES) -> dict:
    """A kernel wrapper's times: ms (`kernel_ms`, the kernel's time, L2
    flushed before each call), l2_warm_ms (`kernel_ms` back to back),
    host_ms and host_us (`host_paced`, the old yardstick and the wrapper's
    host cost a call)."""
    ms = kernel_ms(fn, launches)
    warm = kernel_ms(fn, launches, flush=False)
    host_ms, host_us = host_paced(fn, launches)
    return dict(ms=ms, l2_warm_ms=warm, host_ms=host_ms, host_us=host_us)


def times_text(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms (graph, L2 flushed; back to back "
            f"{t['l2_warm_ms']:.4f}; host-paced {t['host_ms']:.4f} ms, "
            f"wrapper {t['host_us']:.1f} us a call on the host)")


def bound(nbytes: float, ops: float = 0.0,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: (ms, the bound that decides)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def sweep_bit_equal(tables, rays8, R: int, label: str) -> tuple:
    """dense_sweep.cu against its plain versions on one fused (8, 2R)
    stack, bit for bit: t (as int32 words), idx and the rows of lanes from
    0, R and 2R on, and occlusion, each launched twice. Returns (the hit
    fraction, the largest |t - plain t|)."""
    t_p, i_p = closest_plain(tables, rays8)
    occ_p = shadow_plain(tables, rays8)
    for row_from in (0, R, 2 * R):
        rows_p = rows_plain(tables.shade_table, i_p[row_from:])
        first = cuda_dense.closest_with_row(tables, rays8, row_from)
        again = cuda_dense.closest_with_row(tables, rays8, row_from)
        for got in (first, again):
            assert bits_equal(got[0], t_p), f"{label}: t differs"
            assert bits_equal(got[1], i_p), f"{label}: idx differs"
            assert bits_equal(got[2], rows_p), \
                f"{label}: rows from lane {row_from} differ"
    t_err = max_abs_diff(first[0], t_p)
    for _ in range(2):
        assert torch.equal(cuda_dense.shadow(tables, rays8), occ_p), \
            f"{label}: occlusion differs"
    hits = float((i_p >= 0).float().mean())
    print(f"sweep {label}: {2 * R} lanes ({int((rays8[6] > 0).sum())} "
          f"live), hits {hits:.4f}, occluded "
          f"{float(occ_p.float().mean()):.4f}: t bits, idx, rows (from "
          f"lanes 0, R and 2R) and occlusion bit-equal to the plain "
          f"versions, from two launches each")
    return hits, t_err


def check_sweep(tables, camera, width, height) -> dict:
    """Kernel 1 against its plain versions, bit for bit, on the synthetic
    fused stack and on cornell's real bounce-1 stack: closest + rows,
    closest without rows and any-hit, each timed on both."""
    dev = tables.device
    R = width * height
    stacks = {"synthetic": torch.from_numpy(
                  sweep_inputs(camera, width, height)).to(dev),
              "bounce 1": bounce_rays(tables, camera, width, height, 1,
                                      DEPTH)}
    t_err = 0.0
    for label, rays8 in stacks.items():
        hits, err = sweep_bit_equal(tables, rays8, R, label)
        assert 0.3 < hits < 1.0, f"{label}: implausible hit fraction {hits}"
        t_err = max(t_err, err)
    rays8 = stacks["synthetic"]

    times = {label: (
        kernel_times(lambda: cuda_dense.closest_with_row(tables, st, R)),
        kernel_ms(lambda: cuda_dense.closest_with_row(tables, st, 2 * R)),
        kernel_ms(lambda: cuda_dense.shadow(tables, st)))
        for label, st in stacks.items()}
    t, ms_norows, ms_any = times["synthetic"]
    plain_ms = device_ms(lambda: rows_plain(
        tables.shade_table, closest_plain(tables, rays8)[1][R:]),
        PLAIN_LAUNCHES)
    plain_any = device_ms(lambda: shadow_plain(tables, rays8),
                          PLAIN_LAUNCHES)
    tw = tables.shade_table.shape[0]
    active = int((rays8[6] > 0).sum())
    nbytes = (rays8.numel() * 4 + 2 * R * 4 * 2 + R * 40 * 4
              + tables.features.numel() * 4 + tw * 40 * 4)
    ops = active * tables.valid_count * SWEEP_OPS
    b_ms, b_by = bound(nbytes, ops)
    floor_ms = 1e3 * ops / F32_ROUNDED_OPS_PER_S
    print(f"sweep closest+rows: {times_text(t)} (without rows "
          f"{ms_norows:.4f}, any-hit {ms_any:.4f}), plain {plain_ms:.4f} ms "
          f"(any-hit {plain_any:.4f}), bound {b_ms:.4f} ms ({b_by}, "
          f"{nbytes / 1e6:.1f} MB; {active} live lanes x "
          f"{tables.valid_count} x {SWEEP_OPS} ops), floor of separately "
          f"rounded operations {floor_ms:.4f} ms")
    a, b, c = times["bounce 1"]
    print(f"sweep on the bounce-1 stack: closest+rows {times_text(a)}, "
          f"without rows {b:.4f}, any-hit {c:.4f} (graph, L2 flushed)")
    return dict(name="dense_sweep", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/dense_sweep.cu",
                replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:57",
                max_abs_err=t_err, **t, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def hold_shade(label: str, args: tuple, tex_kw: dict) -> float:
    """The shade kernel against shade_step + next_rays on one bounce's
    inputs: rng words equal, the ray stack equal to the kernel's own rows,
    >= 99.5% of lanes within rtol 1e-4 / atol 1e-5 and flags equal (the
    kernel contracts products into FMAs where the plain version rounds
    each). Returns the largest |error| on the close lanes."""
    out_k, rng_k, rays_k = shade_rows.shade(*args, **tex_kw)
    out_p, rng_p = shade_rows.shade_step(*args, **tex_kw)
    rays_p = shade_rows.next_rays(out_p)
    torch.cuda.synchronize()
    assert torch.equal(rng_k, rng_p), f"{label}: rng words differ"
    assert torch.equal(rays_k, shade_rows.next_rays(out_k)), \
        f"{label}: ray stack disagrees with the kernel's own rows"
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
    equal = (o_k == o_p).all(0).mean()
    print(f"shade {label}: {close.mean():.6f} lanes close, {equal:.6f} "
          f"bit-equal, {flags.mean():.6f} flags equal, ray stack close "
          f"{rays_close:.6f}, max abs err on close lanes {err:.3e}, live "
          f"{o_k[0].mean():.3f}, nee {o_k[15].mean():.3f}")
    assert close.mean() >= 0.995 and flags.mean() >= 0.995, label
    assert rays_close >= 0.995, label
    return err


def shade_bytes(tables, R: int) -> int:
    """The white-texel shade kernel's bytes: 252 read and 180 written a
    lane, and the light rows."""
    return (R * (20 * 4 + 8 + 40 * 4 + 4 + 27 * 4 + 8 + 16 * 4)
            + tables.light_rows.numel() * 4)


def check_shade(tables, camera, width, height) -> dict:
    """Kernel 2 (the white-texel instantiation) against shade_step +
    next_rays on real cornell bounces."""
    worst = 0.0
    for depth in (0, 4):
        args = (*bounce_inputs(tables, camera, width, height, depth, DEPTH),
                tables.light_rows, depth, tables.light_count, DEPTH)
        worst = max(worst, hold_shade(f"cornell depth {depth}", args, {}))
        if depth == 0:
            t = kernel_times(lambda: shade_rows.shade(*args))
            plain_ms = device_ms(
                lambda: shade_rows.next_rays(shade_rows.shade_step(*args)[0]),
                PLAIN_LAUNCHES)
            R = width * height
            nbytes = shade_bytes(tables, R)
            b_ms, b_by = bound(nbytes, R * SHADE_OPS)
    print(f"shade: {times_text(t)}, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
    return dict(name="shade_rows", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/shade_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/shade_rows.py:264",
                max_abs_err=worst, **t, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def quads_read(tables, state, rng, rowT, idx) -> int:
    """Texel quads the textured shade kernel reads on one bounce's inputs:
    one per lane and slot whose index is >= 0, base colour and normal map
    on hit lanes, metallic-roughness and emissive on live lanes, and the
    picked light's base colour on every lane."""
    col = SHADE_COLS["tex"][0]
    hit = idx >= 0
    live = (state[0] > 0.5) & hit
    n = sum(int((mask & (rowT[col + k] >= 0)).sum())
            for k, mask in ((BASE, hit), (NORMAL, hit), (METAL_ROUGH, live),
                            (EMISSIVE, live)))
    lc = tables.light_count
    _, (r0,) = rand_n(rng, 1)  # the light pick draw
    pick = torch.clamp((r0 * float(max(lc, 1))).to(torch.int64), 0,
                       max(lc - 1, 0))
    return n + int((tables.light_rows[pick, col + BASE] >= 0).sum())


def check_shade_textured(cases, cornell) -> dict:
    """The textured instantiation against shade_step + next_rays with the
    same texture pyramid, on (label, tables, camera, textures, width,
    height, depths) cases; the first case's bounce 0 is timed for the JSON
    line beside its byte bound (the white-texel lane's 432 bytes plus 16
    per texel quad read), and so is each case's bounce 0 and, at the same
    lane count, the white-texel kernel on `cornell`: (tables, {(width,
    height): camera})."""
    worst, timed = 0.0, []
    for label, tables, camera, textures, width, height, depths in cases:
        kw = dict(textures=textures)
        for depth in depths:
            inputs = bounce_inputs(tables, camera, width, height, depth,
                                   DEPTH, textures)
            args = (*inputs, tables.light_rows, depth, tables.light_count,
                    DEPTH)
            worst = max(worst, hold_shade(f"{label} depth {depth}", args,
                                          kw))
            if depth != 0:
                continue
            R = width * height
            quads = quads_read(tables, *inputs)
            nbytes = shade_bytes(tables, R) + 16 * quads
            ops = R * (SHADE_OPS + TEXCOORD_OPS) + quads * TEXEL_OPS
            b_ms, b_by = bound(nbytes, ops)
            t = kernel_times(lambda: shade_rows.shade(*args, **kw))
            plain_ms = device_ms(lambda: shade_rows.next_rays(
                shade_rows.shade_step(*args, **kw)[0]), PLAIN_LAUNCHES)
            c_tables, c_cams = cornell
            c_args = (*bounce_inputs(c_tables, c_cams[width, height], width,
                                     height, 0, DEPTH),
                      c_tables.light_rows, 0, c_tables.light_count, DEPTH)
            white_ms = kernel_ms(lambda: shade_rows.shade(*c_args))
            print(f"shade textured {label} depth 0, {R} lanes, {quads} "
                  f"quads read ({quads / R:.2f} a lane): {times_text(t)}, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}, {nbytes / 1e6:.1f} MB); the white-texel "
                  f"kernel on cornell at the same lane count {white_ms:.4f} "
                  f"ms (graph; {t['ms'] / white_ms:.2f}x)")
            timed.append((t, plain_ms, b_ms, b_by))
    t, plain_ms, b_ms, b_by = timed[0]
    return dict(name="shade_rows_textured", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/shade_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/shade_rows.py:264",
                path="every textured scene's bounces at max_depth > 0",
                max_abs_err=worst, **t, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def fma_ties(level, tex, u, v) -> tuple[int, int]:
    """The sampler's nine fused multiply-adds a lane (three lerps a
    channel) on the lanes with tex >= 0: (how many the plain version's f64
    emulation rounds otherwise than a true f32 fma, how many in all), each
    fed the plain version's own inputs."""
    has = tex >= 0
    rows, wx, wy = texel_rows(level, tex, u, v)
    q = fetch_quad_plain(level.flat, rows)[has]
    wx, wy = wx[has], wy[has]
    corner = [[((q[:, k] >> sh) & 0xFF).to(torch.float32) * (1.0 / 255.0)
               for sh in (16, 8, 0)] for k in range(4)]
    bad = total = 0
    for ch in range(3):
        c0, c1, c2, c3 = (corner[k][ch] for k in range(4))
        top, top_x = fma_rounding(c1, wx, c0 * (1 - wx))
        bot, bot_x = fma_rounding(c3, wx, c2 * (1 - wx))
        rgb, rgb_x = fma_rounding(top, 1 - wy, bot * wy)
        for emu, exact in ((top, top_x), (bot, bot_x), (rgb, rgb_x)):
            bad += int((emu != exact).sum())
            total += emu.numel()
    return bad, total


def same_worklists(a, b, ct) -> bool:
    """Two (order, counts) pairs hold the same lists: equal counts, and
    equal entries ahead of the count (the kernel writes no others)."""
    pos = torch.arange(ct, device=a[1].device)[None, :] < a[1][:, None]
    return torch.equal(a[1], b[1]) and torch.equal(
        torch.where(pos, a[0], -1), torch.where(pos, b[0], -1))


def dead_lane_stacks(rays_s, g):
    """(label, stack) of the first CULL_EDGE_GROUPS groups of a sorted
    stack: with the first group's even lanes and second half dead (out of
    the sort's order), and with every lane dead."""
    half = rays_s[:, :CULL_EDGE_GROUPS * g].clone()
    half[6, 0:g:2] = 0.0
    half[6, g // 2:g] = 0.0
    dead = half.clone()
    dead[6] = 0.0
    return [("first group half dead", half), ("all dead", dead)]


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
    rays_s, perm = coherence_sort(rays8, tables.box, g, R)
    box_plain = box6(spheres)  # the plain versions' box, reduced here

    def cull(stack=rays_s):
        return cuda_jobs.worklists(spheres, stack, g, tables.box)

    order, counts = cull()
    order_p, counts_p = worklists_plain(spheres, rays_s, g, box_plain)
    torch.cuda.synchronize()
    assert same_worklists((order, counts), (order_p, counts_p), ct), \
        "worklists differ from the plain cull's"
    ids = torch.arange(ct, device=counts.device)
    placed = ids[None, :] < counts_p[:, None]
    cull_err = max(max_abs_diff(counts, counts_p),
                   max_abs_diff(torch.where(placed, order, -1),
                                torch.where(placed, order_p, -1)))
    # The warps OR their votes into shared memory in an order that varies.
    assert same_worklists(cull(), (order, counts), ct), \
        "cull differs between two launches"
    for label, stack in dead_lane_stacks(rays_s, g):
        lists = cull(stack)
        assert same_worklists(
            lists, worklists_plain(spheres, stack, g, box_plain),
            ct), f"cull, {label}: differs from plain"
        assert (int(lists[1].sum()) == 0) == (label == "all dead"), label
    live = int((rays_s[6] > 0).sum())
    n_pairs = int(counts.sum())
    G = counts.shape[0]
    busy = counts > 0
    print(f"cull: {2 * R} lanes ({live} live) x {ct} clusters, {G} groups "
          f"of {g}; worklists equal to the plain cull, from a second launch, "
          f"and on {CULL_EDGE_GROUPS} groups with the first half dead and "
          f"with all dead; length mean "
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
    chunk = tune.JOB_CHUNK
    for st in (stats, stats_any):
        assert torch.equal(st[:, 2], counts), "stats: worklist lengths"
        assert torch.equal(st[:, 3], (counts + chunk - 1) // chunk), \
            "stats: chunks"
        assert (st[:, 0] <= st[:, 2]).all() and (st[:, 1] >= st[:, 0]).all()
        assert (st[:, 1] <= g * st[:, 0]).all()
    # A worklist walked in one chunk counts what the plain walk counts; a
    # split one's chunks prune one another as they finish.
    held = torch.nonzero((counts > 0) & (counts <= chunk)).flatten()
    held = held[:JOB_STATS_GROUPS]
    assert held.numel() > 0, "no non-empty group is walked in one chunk"
    lanes_st = (held[:, None] * g + torch.arange(g, device=held.device)
                ).flatten()
    sub_st = (rays_s[:, lanes_st], order[held], counts[held])
    for any_hit, st in ((False, stats), (True, stats_any)):
        assert torch.equal(jobs_stats_plain(tables, *sub_st, g, any_hit,
                                            chunk),
                           st[held].cpu()), "plain job stats"
    split = counts > chunk
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
          f"the plain count on {held.numel()} groups walked in one chunk; "
          f"two launches bit-equal; chunks of {chunk}: "
          f"{int(split.sum())} of {int((counts > 0).sum())} non-empty groups "
          f"split, {int(stats[:, 3].sum())} chunks")

    sort_ms = device_ms(lambda: coherence_sort(rays8, tables.box, g, R),
                        PLAIN_LAUNCHES)
    cull_t = kernel_times(cull)
    cull_plain_ms = device_ms(lambda: worklists_plain(
        spheres, rays_s[:, :L], g, box_plain), PLAIN_LAUNCHES)
    job_t = kernel_times(lambda: jobs(False))
    job_any_ms = kernel_ms(lambda: jobs(True))
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
    cull_floor_ms = 1e3 * live * ct * CULL_OPS / F32_ROUNDED_OPS_PER_S
    t_s = torch.where(perm < 2 * R, t[perm.long().clamp(max=2 * R - 1)], 0.0)
    lane_pairs = needed_pairs(tables, rays_s, t_s)
    tiles_read = int(worklist_mask(order, counts, ct).any(0).sum())
    ext_hits = int((idx[R:] >= 0).sum())
    job_bytes = (2 * R * (32 + 4) + G * 4 + n_pairs * 4
                 + tiles_read * 25 * 128 * 4 + 2 * R * 8 + R * 40 * 4
                 + ext_hits * 40 * 4)
    jb_ms, jb_by = bound(job_bytes, lane_pairs * 128 * SWEEP_OPS)
    print(f"coherence sort (torch sort + gather, {2 * R} lanes): "
          f"{sort_ms:.4f} ms")
    print(f"cull: {times_text(cull_t)}, plain {cull_plain_ms:.4f} ms on "
          f"the first {JOB_PLAIN_GROUPS} groups ({L} lanes), bound "
          f"{cb_ms:.4f} ms ({cb_by}, {live} live lanes x {ct} x {CULL_OPS} "
          f"ops, {cull_bytes / 1e6:.1f} MB), floor of separately rounded "
          f"operations {cull_floor_ms:.4f} ms")
    print(f"job sweep closest+rows: {times_text(job_t)} (any-hit "
          f"{job_any_ms:.4f} ms, graph), plain {job_plain_ms:.4f} ms on the "
          f"first "
          f"{JOB_PLAIN_GROUPS} groups, bound {jb_ms:.4f} ms ({jb_by}, "
          f"{lane_pairs} (lane, tile) pairs a lane's segment up to its hit "
          f"touches x 128 x {SWEEP_OPS} ops; walked: "
          f"{int(stats[:, 1].sum())} pairs in {int(stats[:, 0].sum())} of "
          f"the {n_pairs} jobs (any-hit {int(stats_any[:, 1].sum())} in "
          f"{int(stats_any[:, 0].sum())}), against {n_pairs * g} pairs in "
          f"the groups' worklists; {tiles_read} tiles read, "
          f"{job_bytes / 1e6:.1f} MB); whole path (sort + cull + sweep) "
          f"{path_ms:.4f} ms; dense_sweep over every tile {full_ms:.4f} ms")
    return [dict(name="job_sweep", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/job_sweep.cu",
                 replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:991",
                 max_abs_err=max_abs_diff(t_p[keep], t[lanes[keep]]),
                 **job_t, plain_ms=job_plain_ms, bound_ms=jb_ms,
                 bound_by=jb_by, library_ms=None),
            dict(name="cluster_cull", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/cluster_cull.cu",
                 replaces="webgpu_raytracer_tpu/ops/cluster_cull.py:26",
                 max_abs_err=cull_err, **cull_t, plain_ms=cull_plain_ms,
                 bound_ms=cb_ms, bound_by=cb_by, library_ms=None)]


def check_scan(tables, camera, width, height) -> list[dict]:
    """The scan path's kernels on the fused sweep of bounce 1 (2R lanes, in
    ray tiles of M_TILE2): the keyed cull bit-equal to its plain version on
    every tile; the scan kernel bit-equal to the sweep kernel walking every
    tile, with the exact and with the cone cull's worklists, and to its
    plain version (outputs and per-tile stats) on the first
    SCAN_PLAIN_TILES tiles of each segment (shadow lanes, extension lanes).
    Times the job path again beside the scan path."""
    R = width * height
    m = M_TILE2
    assert R % m == 0
    dev = tables.device
    spheres = tables.spheres
    ct = spheres.shape[0]
    rays8 = bounce_rays(tables, camera, width, height, 1, DEPTH)
    rays_s, perm = coherence_sort(rays8, tables.box, m, R)
    box_plain = box6(spheres)  # the plain versions' box, reduced here
    T = rays_s.shape[1] // m

    def cull(stack=rays_s):
        return cuda_scan.cluster_keys(spheres, stack, m, tables.box)

    key_map = cull()
    order, keys, counts = sort_keyed(key_map)
    tiles = (list(range(SCAN_PLAIN_TILES))
             + list(range(R // m, R // m + SCAN_PLAIN_TILES)))
    tiles_t = torch.tensor(tiles, device=dev)
    sub_s = torch.cat([rays_s[:, t * m:(t + 1) * m] for t in tiles], 1)
    keys_p = keys_plain(spheres, rays_s, m, box_plain)
    torch.cuda.synchronize()
    assert (counts[tiles_t] > 0).all(), "a checked tile is dead"
    assert bits_equal(key_map, keys_p), \
        "keyed cull: keys differ from the plain cull's"
    key_err = max_abs_diff(key_map, keys_p)
    # The warps take their minima into shared memory in an order that
    # varies.
    assert bits_equal(cull(), key_map), \
        "keyed cull differs between two launches"
    for label, stack in dead_lane_stacks(rays_s, m):
        got = cull(stack)
        assert bits_equal(got, keys_plain(spheres, stack, m, box_plain)), \
            f"keyed cull, {label}: differs from plain"
        assert bool((got == 3e38).all()) == (label == "all dead"), label
    assert (keys[:, 1:] >= keys[:, :-1]).all(), "keys not ascending"
    live = int((rays_s[6] > 0).sum())
    n_entries = int(counts.sum())
    busy = counts > 0
    n_busy = max(int(busy.sum()), 1)
    print(f"keyed cull: {2 * R} lanes ({live} live) x {ct} clusters, {T} "
          f"tiles of {m} ({int(busy.sum())} non-empty); keys bit-equal to "
          f"the plain keyed cull on every tile, from a second launch, and "
          f"on {CULL_EDGE_GROUPS} tiles with the first half dead and with "
          f"all dead; worklist length over non-empty tiles mean "
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

    cone = cuda_scan.worklists_keyed(spheres, rays_s, m, tables.box, "cone")
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
    rays_j, perm_j = coherence_sort(rays8, tables.box, g, R)
    order_j, counts_j = cuda_jobs.worklists(spheres, rays_j, g, tables.box)

    def jobs():
        return cuda_jobs.job_sweep(tables, rays_j, perm_j, order_j, counts_j,
                                   g, 2 * R, False, R)

    def path(narrow):
        return cuda_dense.closest_with_row(tables, rays8, R, narrow=narrow)

    cull_t = kernel_times(cull)
    cull_plain_ms = device_ms(lambda: keys_plain(spheres, sub_s, m, box_plain),
                              PLAIN_LAUNCHES)
    sort_ms = device_ms(lambda: sort_keyed(key_map))
    cone_ms = device_ms(lambda: cuda_scan.worklists_keyed(
        spheres, rays_s, m, tables.box, "cone"), PLAIN_LAUNCHES)
    job_a = kernel_ms(jobs, 50)
    scan_t = kernel_times(lambda: scan(False))
    scan_any_ms = kernel_ms(lambda: scan(True))
    job_b = kernel_ms(jobs, 50)
    scan_cone_ms = kernel_ms(lambda: scan(False, cone), 50)
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
    cull_floor_ms = 1e3 * live * ct * KEYED_CULL_OPS / F32_ROUNDED_OPS_PER_S
    t_s = torch.where(perm < 2 * R, t[perm.long().clamp(max=2 * R - 1)], 0.0)
    lane_pairs = needed_pairs(tables, rays_s, t_s)
    tiles_read = int(exact_mask.any(0).sum())
    ext_hits = int((idx[R:] >= 0).sum())
    scan_bytes = (2 * R * (32 + 4) + T * 4 + n_entries * 8
                  + tiles_read * 25 * 128 * 4 + 2 * R * 8 + R * 40 * 4
                  + ext_hits * 40 * 4)
    sb_ms, sb_by = bound(scan_bytes, lane_pairs * 128 * SWEEP_OPS)
    print(f"keyed cull: {times_text(cull_t)}, plain {cull_plain_ms:.4f} "
          f"ms on {len(tiles)} tiles ({len(tiles) * m} lanes), bound "
          f"{cb_ms:.4f} ms ({cb_by}, {live} live lanes x {ct} x "
          f"{KEYED_CULL_OPS} ops, {cull_bytes / 1e6:.1f} MB), floor of "
          f"separately rounded operations {cull_floor_ms:.4f} ms; torch.sort "
          f"of the ({T}, {ct}) keys {sort_ms:.4f} ms; cone cull (plain torch, "
          f"sort included) {cone_ms:.4f} ms")
    print(f"scan sweep closest+rows: {times_text(scan_t)} (any-hit "
          f"{scan_any_ms:.4f} ms; on the cone cull's worklists "
          f"{scan_cone_ms:.4f} ms; graph), plain {scan_plain_ms:.4f} ms on "
          f"{len(tiles)} tiles, bound {sb_ms:.4f} ms ({sb_by}, {lane_pairs} "
          f"(lane, tile) pairs a lane's segment up to its hit touches x 128 "
          f"x {SWEEP_OPS} ops; walked: {int(stats[:, 3].sum())} pairs "
          f"(any-hit {int(stats_any[:, 3].sum())}), against {pr * m} in the "
          f"processed entries and {n_entries * m} in the worklists; "
          f"{tiles_read} tiles read, "
          f"{scan_bytes / 1e6:.1f} MB); job sweep in the same call "
          f"{job_a:.4f} / {job_b:.4f} ms (graph, before / after); whole path "
          f"(sort "
          f"+ cull + sweep) scan {path_ms:.4f} ms, jobs {path_jobs_a:.4f} / "
          f"{path_jobs_b:.4f} ms")
    return [dict(name="scan_sweep", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/scan_sweep.cu",
                 replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:323",
                 max_abs_err=max_abs_diff(t_p[keep], t[lanes[keep]]),
                 **scan_t, plain_ms=scan_plain_ms,
                 bound_ms=sb_ms, bound_by=sb_by, library_ms=None),
            dict(name="cluster_cull_keyed", route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/cluster_cull.cu",
                 replaces="webgpu_raytracer_tpu/ops/cluster_cull.py:26",
                 max_abs_err=key_err, **cull_t, plain_ms=cull_plain_ms,
                 bound_ms=cb_ms, bound_by=cb_by, library_ms=None)]


def needed_pairs(tables, rays_s, t_end) -> int:
    """(lane, tile) pairs of a sorted stack whose segment (T_MIN, min(t_clip,
    t_end)) can touch the tile's sphere (the cull's test, lane by lane)."""
    spheres = tables.spheres
    dd, t_clip = lane_terms(rays_s, tables.box)
    t_clip = torch.minimum(t_clip, t_end)
    n = torch.zeros((), dtype=torch.int64, device=rays_s.device)
    for l0 in range(0, rays_s.shape[1], LANE_CHUNK):
        lanes = slice(l0, l0 + LANE_CHUNK)
        for c0 in range(0, spheres.shape[0], CLUSTER_CHUNK):
            n += pair_ok(rays_s[:, lanes], dd[lanes], t_clip[lanes],
                         spheres[c0:c0 + CLUSTER_CHUNK]).sum()
    return int(n)


def time_fetch(label, kernel, plain, library, nbytes) -> dict:
    """The fetch kernel graph-timed and host-paced, its plain version
    host-paced, the library call graph-timed (one torch call: its own
    device time, as the kernel's)."""
    t = kernel_times(kernel)
    plain_ms = device_ms(plain)
    library_ms = kernel_ms(library)
    b_ms, b_by = bound(nbytes)
    print(f"{label}: {times_text(t)}, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms (graph, L2 flushed), bound {b_ms:.4f} ms "
          f"({b_by}, {nbytes / 1e6:.1f} MB)")
    return dict(**t, plain_ms=plain_ms, library_ms=library_ms,
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
        err = max_abs_diff(out_k, out_p)
        n, k = table.shape
        r = idx.shape[0]
        clipped = idx.clamp(0, n - 1)
        print(f"fetch_rows {label}: N {n}, K {k}, R {r}, bit-equal")
        results.append(dict(max_abs_err=err, **time_fetch(
            f"fetch_rows {label}",
            lambda: cuda_fetch.fetch_rows_t(table, idx),
            lambda: fetch_rows_plain(table, idx),
            lambda: table.index_select(0, clipped).T.contiguous(),
            r * 4 + k * r * 4 + n * k * 4)))
    return dict(name="fetch_rows", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/fetch_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:1381",
                **results[0])


def check_fetch_quad(cases) -> dict:
    """Kernel 4 against its plain version on (label, flat, rows) cases;
    the first case's numbers go to the JSON line."""
    results = []
    for label, flat, rows in cases:
        out_k = cuda_fetch.fetch_quad(flat, rows)
        out_p = fetch_quad_plain(flat, rows)
        torch.cuda.synchronize()
        assert bits_equal(out_k, out_p), f"{label}: words differ"
        err = max_abs_diff(out_k, out_p)
        n, r = flat.shape[0], rows.shape[0]
        print(f"fetch_quad {label}: N {n}, R {r}, bit-equal")
        results.append(dict(max_abs_err=err, **time_fetch(
            f"fetch_quad {label}",
            lambda: cuda_fetch.fetch_quad(flat, rows),
            lambda: fetch_quad_plain(flat, rows),
            lambda: flat.index_select(0, rows),
            r * 4 + r * 16 + n * 16)))
    return dict(name="fetch_quad", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/fetch_rows.cu",
                replaces="webgpu_raytracer_tpu/ops/pallas_dense.py:1438",
                **results[0])


def bvh_rays(camera, width, height, tables):
    """The BVH walk's test stacks on one scene: its (R, 3) pinhole
    primaries, and the dense path's bounce-1 rays at the same camera (the
    R NEE shadow rays and the R extension rays of `bounce_rays`), each with
    its per-lane t_max and active lanes t_max > 0."""
    R = width * height
    ro3, rd3 = pinhole_rays(camera, width, height)
    prim = (torch.stack(list(ro3), 1).contiguous(),
            torch.stack(list(rd3), 1).contiguous())
    rays8 = bounce_rays(tables, camera, width, height, 1, DEPTH)

    def part(lo):
        s = rays8[:, lo:lo + R]
        t = s[6].contiguous()
        return (s[3:6].T.contiguous(), s[0:3].T.contiguous(), t, t > 0)

    return prim, part(0), part(R)


def walk_bound(scene, ro, any_hit, per_lane_tmax, st,
               tri_ops: int = BVH_TRI_OPS) -> tuple:
    """(bound ms, deciding, MB, G ops): rays in, results out, the scene's
    node, triangle, vertex and instance arrays once; operations from the
    walk's own counts of nodes visited and triangles tested, tri_ops a
    triangle."""
    R = ro.shape[0]
    nbytes = (R * (24 + 1 + (4 if per_lane_tmax else 0))
              + R * (1 if any_hit else 12)
              + sum(getattr(scene, k).numel() * 4 for k in (
                  "node_min", "node_max", "node_skip", "node_data", "tri_v",
                  "pos", "inst_inv", "inst_blas")))
    ops = (float(st.nodes.double().sum()) * BVH_NODE_OPS
           + float(st.tris.double().sum()) * tri_ops)
    b_ms, b_by = bound(nbytes, ops)
    return b_ms, b_by, nbytes / 1e6, ops / 1e9


def check_bvh(cases) -> list[dict]:
    """`csrc/bvh_walk.cu` against its plain walk, bit for bit, closest and
    any-hit, on each (label, DeviceScene, WalkPack, camera, dense tables)
    case at 512^2: the primaries (any-hit at t_max half or 1.01x the
    closest hit, alternately), the bounce-1 rays, and the primaries with
    every 3rd lane poisoned (NaN / inf in o, d or t_max). Timed on the
    finite stacks (kernel over 200 launches, plain walk once); the JSON
    line takes the last case's primaries (closest) and bounce-1 shadow rays
    (any-hit)."""
    width, height = SMALL
    out = {}
    for label, scene, pack, camera, tables in cases:
        (p_ro, p_rd), shadow, ext = bvh_rays(camera, width, height, tables)
        R = p_ro.shape[0]
        on = torch.ones(R, dtype=torch.bool, device=p_ro.device)
        hit, st_c, err_c = walk_bit_equal(
            scene, p_ro, p_rd, T_MAX, on, False, f"{label} primaries, closest",
            pack)
        half = torch.arange(R, device=p_ro.device) % 2 == 0
        t_sh = torch.where(hit.inst_idx >= 0,
                           torch.where(half, hit.t * 0.5, hit.t * 1.01),
                           5.0).contiguous()
        walk_bit_equal(scene, p_ro, p_rd, t_sh, on, True,
                       f"{label} primaries, any-hit", pack)
        _, st_e, err_e = walk_bit_equal(
            scene, *ext, False, f"{label} bounce-1 extension rays, closest",
            pack)
        _, st_s, err_s = walk_bit_equal(
            scene, *shadow, True, f"{label} bounce-1 shadow rays, any-hit",
            pack)
        bad = poison_lanes(p_ro, p_rd, t_sh, R)
        some = torch.arange(R, device=p_ro.device) % 7 != 0
        for any_hit in (False, True):
            _, _, err = walk_bit_equal(
                scene, *bad, some, any_hit, f"{label} primaries, every 3rd "
                f"lane NaN / inf, {'any-hit' if any_hit else 'closest'}",
                pack)
            err_c, err_s = ((err_c, max(err_s, err)) if any_hit
                            else (max(err_c, err), err_s))
        for name, args, any_hit, st, tl, err in (
                ("bvh_closest", (p_ro, p_rd, T_MAX, on), False, st_c, False,
                 err_c),
                ("bvh_closest ext", ext, False, st_e, True, err_e),
                ("bvh_shadow", shadow, True, st_s, True, err_s)):
            t = kernel_times(lambda: intersect.walk_cuda(
                scene, args[0], args[1], T_MIN, args[2], args[3], any_hit,
                pack=pack))
            t0 = time.perf_counter()
            intersect.traverse_plain(scene, args[0], args[1], T_MIN, args[2],
                                     args[3], any_hit)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            b_ms, b_by, mb, gops = walk_bound(scene, args[0], any_hit, tl, st)
            b_old = walk_bound(scene, args[0], any_hit, tl, st,
                               BVH_TRI_OPS_UNPACKED)[0]
            print(f"{name} {label}: {times_text(t)}, plain walk "
                  f"{plain_ms:.1f} ms (host clock, one call), bound "
                  f"{b_ms:.4f} ms ({b_by}; {mb:.1f} MB, {gops:.3f} G ops: "
                  f"{BVH_NODE_OPS} a node, {BVH_TRI_OPS} a triangle); at "
                  f"{BVH_TRI_OPS_UNPACKED} a triangle, as the unpacked walk "
                  f"counted, {b_old:.4f} ms")
            out[name] = dict(**t, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err)
    return [dict(name=name, route="cuda",
                 source="webgpu_raytracer_tpu_torch/csrc/bvh_walk.cu",
                 replaces="webgpu_raytracer_tpu/ops/intersect.py:104",
                 library_ms=None, **out[name])
            for name in ("bvh_closest", "bvh_shadow")]


def bvh_shade_bytes(args) -> int:
    """Bytes the BVH shade must move on one bounce's inputs: each lane's
    inputs and outputs once, and the distinct rows its found lanes gather:
    triangles (hit and light), their vertices, instances, light rows, and
    the texel quads of the hit's texture slots (the light's quads are not
    counted, so this undercounts a textured light)."""
    scene, state, rng, ro, rd, active, tri, inst, occluded = args[:9]
    R = ro.shape[0]
    lane_in = 13 * 4 + 8 + 24 + 8 + (active is not None) + (
        occluded is not None)
    lane_out = 13 * 4 + 8 + 24 + 1 + 24 + 4 + 1
    found = inst >= 0 if active is None else active & (inst >= 0)
    lc = scene.light_count
    _, (r0,) = rand_n(rng, 1)  # the light pick draw
    pick = torch.clamp((r0 * float(max(lc, 1))).to(torch.int64), 0,
                       max(lc - 1, 0))[found]
    lights = scene.lights[pick].long()
    tris = torch.unique(torch.cat([tri[found].long(), lights[:, 1]]))
    verts = torch.unique(scene.tri_v[tris].reshape(-1))
    insts = torch.unique(torch.cat([inst[found].long(), lights[:, 0]]))
    nbytes = (R * (lane_in + lane_out) + tris.numel() * (12 + 12 + 4 + 12
                                                         + 16 + 12)
              + verts.numel() * (12 + 12 + 8) + insts.numel() * 2 * 64
              + torch.unique(pick).numel() * 8)
    tex = scene.textures
    if not tex.is_floating_point():
        k, th, tw = tex.shape[:3]
        hd = load_hit(scene, ro[found], rd[found], tri[found], inst[found])
        slots = scene.tri_tex[tri[found].long()]
        u = hd.tex_uv[:, 0] - torch.floor(hd.tex_uv[:, 0])
        v = hd.tex_uv[:, 1] - torch.floor(hd.tex_uv[:, 1])
        x0 = torch.floor(u * tw - 0.5).long()
        y0 = torch.floor(v * th - 0.5).long()
        quads = [((slots[:, c].clamp(0, k - 1) * th + y0 % th) * tw
                  + x0 % tw)[slots[:, c] >= 0] for c in range(4)]
        nbytes += torch.unique(torch.cat(quads)).numel() * 16
    return nbytes


def profile_kernels(fn, n: int, tries: int = 3) -> tuple[list, float]:
    """([(kernel, self device us, count)], wall us) of n calls of fn under
    torch.profiler: the device's own events (a CPU op's device time repeats
    its kernels'), and the host clock over the calls, ending in a
    synchronise. The profiler can drop device records (a path once read 0
    launches): a profile that sees fewer device launches than the port's
    own counters counted is taken again, up to `tries` times, then raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        before = dict(kernels.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        # "bvh_walk" counts the closest and any-hit walks a second time.
        ours = sum(v - before.get(k, 0) for k, v in kernels.launches.items()
                   if k != "bvh_walk")
        events = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        seen = sum(c for _, _, c in events)
        if seen >= max(ours, 1):
            return events, wall_us
        print(f"profile: {seen} device launches seen, the port counted "
              f"{ours}; profiling again")
    raise AssertionError(f"the profiler saw {seen} device launches in "
                         f"{tries} tries; the port counted {ours}")


def profiled_ms(fn, name: str, n: int = 20) -> float:
    """The profiler's own device ms a launch of the kernels whose name
    holds `name`, over n calls of fn (`profile_kernels`). Back to
    back, so L2 stays warm."""
    fn()
    torch.cuda.synchronize()
    events = [e for e in profile_kernels(fn, n)[0] if name in e[0]]
    count = sum(c for _, _, c in events)
    assert count == n, f"profiled {count} launches of {name}, expected {n}"
    return sum(t for _, t, _ in events) / count / 1e3


def time_bvh_shade(label: str, args: tuple, kw: dict) -> dict:
    """`bvh_shade` on one bounce's inputs: kernel_times (over the pack in
    `kw`), the byte bound and share (bound / kernel ms). Prints one line."""
    t = kernel_times(lambda: bvh_shade.bvh_shade(*args, **kw))
    nbytes = bvh_shade_bytes(args)
    found = int((args[7] >= 0).sum()) if args[5] is None else int(
        (args[5] & (args[7] >= 0)).sum())
    b_ms, b_by = bound(nbytes, found * BVH_SHADE_OPS, F32_ROUNDED_OPS_PER_S)
    print(f"bvh shade {label}, {args[3].shape[0]} lanes ({found} found): "
          f"{times_text(t)}, bound {b_ms:.4f} ms ({b_by}, "
          f"{nbytes / 1e6:.1f} MB, {found} x {BVH_SHADE_OPS} ops at one an "
          f"instruction), share of the bound {b_ms / t['ms']:.3f}")
    return dict(t, bound_ms=b_ms, bound_by=b_by, share=b_ms / t["ms"])


def bvh_shade_host_split(args, kw, n: int = KERNEL_LAUNCHES) -> dict:
    """Host us a call of the parts of one `bvh_shade` wrapper call over the
    ShadePack in `kw`, each timed on the host clock over n calls with no
    synchronise (and one after): the per-lane checks, the nine output
    allocations, the device context, the stream lookup, the ctypes launch
    alone (into outputs made once), and the whole wrapper, allocating its
    outputs or writing into `out`. Prints one line."""
    scene, state, rng, ro, rd, active, tri, inst, occ, depth, md = args
    dev, R = state.device, ro.shape[0]
    pack = kw["pack"]
    lanes = ((state, torch.float32, (bvh_shade.NS, R)),
             (rng, torch.int64, (R,)), (ro, torch.float32, (R, 3)),
             (rd, torch.float32, (R, 3)), (tri, torch.int32, (R,)),
             (inst, torch.int32, (R,)))

    def checks():
        for t, dtype, shape in lanes:
            kernels.check(t, "t", dtype, shape, dev)

    def context():
        with torch.cuda.device(dev):
            pass

    state_o, rng_o, nxt_o = outs = bvh_shade.shade_outputs(R, dev)
    p = kernels.ptr

    def launch():
        kernels.library().wrt_bvh_shade(
            ctypes.addressof(pack.view), int(pack.textured), p(state),
            p(rng), p(ro), p(rd), p(active), p(tri), p(inst), p(occ), depth,
            md, R, p(state_o), p(rng_o), *(p(t) for t in nxt_o),
            kernels.stream(dev))

    res = {}
    for name, fn in (("checks", checks),
                     ("allocations", lambda: bvh_shade.shade_outputs(R, dev)),
                     ("device context", context),
                     ("stream", lambda: kernels.stream(dev)),
                     ("ctypes launch", launch),
                     ("wrapper", lambda: bvh_shade.bvh_shade(*args, **kw)),
                     ("wrapper into out", lambda: bvh_shade.bvh_shade(
                         *args, **kw, out=outs))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        res[name] = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
    print("bvh_shade wrapper, host us a call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in res.items()))
    return res


def check_bvh_shade(cases) -> dict:
    """`csrc/bvh_shade.cu` against `bvh_shade_step` on (label, DeviceScene,
    camera, (width, height)) cases, bounces 0 and 4 of a DEPTH frame, each
    timed (`time_bvh_shade`), the plain step at bounce 0 over 20 calls. The
    profiler's own device time a launch (back to back) cross-checks the
    back-to-back graph time at `spheres` 512^2 bounce 0, whose numbers go
    to the JSON line, and the wrapper's host cost is split into its parts
    there (`bvh_shade_host_split`)."""
    worst, row = 0.0, None
    for label, scene, camera, (width, height) in cases:
        pack = intersect.pack_walk(scene)
        kw = shade_kw(scene)
        for depth in (0, 4):
            args = bvh_bounce_inputs(scene, camera, width, height, depth,
                                     pack, kw)
            tag = f"{label} depth {depth}"
            worst = max(worst, hold_bvh_shade(tag, args))
            t = time_bvh_shade(tag, args, kw)
            if depth != 0:
                continue
            plain_ms = device_ms(lambda: bvh_shade.bvh_shade_step(*args),
                                 PLAIN_LAUNCHES)
            print(f"bvh shade {tag}: plain {plain_ms:.4f} ms; {DEPTH} "
                  f"launches a frame")
            if label == "spheres 512^2":
                prof = profiled_ms(lambda: bvh_shade.bvh_shade(*args, **kw),
                                   "bvh_shade_kernel")
                print(f"bvh shade {tag}: profiler's own device time "
                      f"{prof:.4f} ms a launch, back to back (graph back "
                      f"to back {t['l2_warm_ms']:.4f}, L2 flushed "
                      f"{t['ms']:.4f})")
                row = dict(t, plain_ms=plain_ms, profiled_ms=prof)
                bvh_shade_host_split(args, kw)
    return dict(name="bvh_shade", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/bvh_shade.cu",
                replaces="webgpu_raytracer_tpu/ops/trace.py:307",
                path="the BVH path's bounces (trace_pixels, get_tracer"
                "(\"bvh\"), the sharded steps)",
                max_abs_err=worst, library_ms=None,
                **{k: row[k] for k in ("ms", "l2_warm_ms", "host_ms",
                                       "host_us", "plain_ms", "bound_ms",
                                       "bound_by", "profiled_ms")})


def check_present(sizes) -> dict:
    """The present pass against `postprocess` at each (width, height):
    image and history bit for bit on frames 1 (the resample, past the
    edge) and 17 (with and without it); then timed on frame 17 without
    the resample (the interactive cells' graph), the resample's path at
    frame 1 beside it, the plain chain host-paced and graph-timed. The
    first size's numbers go to the JSON line."""
    rows = []
    for width, height in sizes:
        acc, hist = present_inputs(height, width, width, DEVICE)
        tag = f"present {width}x{height}"
        for frame, jitter, unjitter in ((1, PRESENT_JITTERS[1], True),
                                        (17, PRESENT_JITTERS[0], True),
                                        (17, PRESENT_JITTERS[0], False)):
            hold_present(acc, hist, frame, torch.tensor(jitter,
                                                        device=DEVICE),
                         unjitter)
        jit = torch.tensor(PRESENT_JITTERS[0], device=DEVICE)
        frame = torch.full((), 17, dtype=torch.int64, device=DEVICE)
        first = torch.ones((), dtype=torch.int64, device=DEVICE)
        buf = hist.clone()
        t = kernel_times(lambda: cuda_present.present(acc, buf, frame, jit,
                                                      False))
        resample_ms = kernel_ms(lambda: cuda_present.present(acc, buf, first,
                                                             jit, True))
        plain_ms = device_ms(lambda: postprocess(acc, hist, frame, jit,
                                                 False), PLAIN_LAUNCHES)
        plain_graph_ms = kernel_ms(lambda: postprocess(acc, hist, frame, jit,
                                                       False), PLAIN_LAUNCHES)
        px = width * height
        b_ms, b_by = bound(px * PRESENT_BYTES, px * PRESENT_OPS,
                           F32_ROUNDED_OPS_PER_S)
        print(f"{tag}: bit-equal to postprocess (frames 1 and 17, with and "
              f"without the resample); {times_text(t)}; the resample's "
              f"path {resample_ms:.4f} ms; plain chain host-paced "
              f"{plain_ms:.4f} ms, graph {plain_graph_ms:.4f} ms (L2 "
              f"flushed); bound {b_ms:.4f} ms ({b_by}, "
              f"{px * PRESENT_BYTES / 1e6:.1f} MB); share "
              f"{b_ms / t['ms']:.2f}")
        rows.append(dict(t, plain_ms=plain_ms, plain_graph_ms=plain_graph_ms,
                         resample_ms=resample_ms, bound_ms=b_ms,
                         bound_by=b_by, size=f"{width}x{height}"))
    return dict(name="present", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/present.cu",
                replaces=None, path="present_step (Renderer.present, the "
                "recorder, the farm): the plain chain of ops/postprocess.py",
                max_abs_err=0.0, library_ms=None, **rows[0],
                other_sizes=rows[1:])


def row_launches(seeded: bool = False, multi_tile: bool = False,
                 narrow: str = "jobs", quads: int = 0) -> dict:
    """A frame of the row-state loop at DEPTH: 1 + DEPTH sweeps (the
    primary's, or when seeded the G-buffer's) - a dense sweep each on one
    tile, a cull and a narrow-phase sweep each on several - and DEPTH
    shades; seeded, also one seed-row fetch and `quads` quad fetches (the
    G-buffer's bound base-colour and normal slots)."""
    n = 1 + DEPTH
    sweeps = ({"dense_sweep": n} if not multi_tile else
              {"cluster_cull": n, "job_sweep": n} if narrow == "jobs" else
              {"cluster_cull_keyed": n, "scan_sweep": n})
    return {**sweeps, "shade_rows": DEPTH, "fetch_rows": int(seeded),
            "fetch_quad": quads}


# A frame of the BVH path (`trace_pixels`): the primary and DEPTH - 1
# extension walks, DEPTH shadow walks and DEPTH shades.
BVH_LAUNCHES = {"bvh_closest": DEPTH, "bvh_shadow": DEPTH,
                "bvh_walk": 2 * DEPTH, "bvh_shade": DEPTH}


def present_frame(out: torch.Tensor, size) -> None:
    """Frame 1's present of a path's output (its radiance (R, 3), or a
    sharded step's accumulator (R, 4)) at size (width, height)."""
    width, height = size
    acc = out if out.shape[-1] == 4 else accumulate(
        torch.empty((width * height, 4), device=DEVICE), out, 1)
    present_step(acc, torch.zeros((height, width, 3), device=DEVICE), 1,
                 torch.zeros(2, device=DEVICE), width=width, height=height)


def path_frame(label: str, want: dict, fn, totals: dict, size):
    """Runs fn (one frame of a path) and presents it at size (width,
    height), with the launch counts zeroed just before and asserted
    exactly (a kernel not in `want` or the present's launched nothing);
    adds them to `totals`. Returns (fn's result, the counts)."""
    kernels.reset_launches()
    out = fn()
    present_frame(out, size)
    counts = dict(kernels.launches)
    expect = {**dict.fromkeys(counts, 0), **want,
              "present": cuda_present.LAUNCHES}
    assert counts == expect, f"{label}: launches {counts}, not {expect}"
    print(f"launches, {label}: {({k: v for k, v in counts.items() if v})}")
    for k, v in counts.items():
        totals[k] += v
    return out, counts


def dense_frame(size, tables, camera, textures=None, seeded=False,
                narrow="jobs") -> torch.Tensor:
    """Frame 1 of `trace_pixels_dense` at jitter 0, spp 1, DEPTH: traced,
    or seeded from the G-buffer of the same primary rays."""
    jitter = torch.zeros(2, device=camera.device)
    seed = None
    if seeded:
        seed = render_gbuffer(tables, textures, camera, *size, jitter=jitter,
                              narrow=narrow).wt_idx.reshape(-1)
    return trace_pixels_dense(tables, camera, 1, jitter, *size, 1, DEPTH,
                              textures=textures, seed_wt_idx=seed,
                              narrow=narrow)


def sharded_steps(cases, size, totals: dict) -> None:
    """The tile (spp 1), sample and 2-D (spp 2) steps, eager, on a NCCL
    world of one, frame 1 of each case (backend, scene, camera): launches
    exact (the sample steps' one all-reduce included), the tile step's
    accumulator bit-equal to `get_tracer(backend)` + `accumulate`, the
    others within 2e-5 of it."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device(DEVICE, 0))
    try:
        mesh = sharding.make_mesh(DEVICE)
        mesh2 = sharding.make_mesh(DEVICE, (1, 1), ("tile", "sample"))
        width, height = size
        jitter = torch.zeros(2, device=DEVICE)
        for backend, scene, camera in cases:
            per_spp = (BVH_LAUNCHES if backend == "bvh" else row_launches())
            for kind, make, m, spp in (
                    ("tile", sharding.tile_sharded_step, mesh, 1),
                    ("sample", sharding.sample_sharded_step, mesh, 2),
                    ("tile x sample", sharding.tile_sample_sharded_step,
                     mesh2, 2)):
                ref = accumulate(
                    torch.zeros((width * height, 4), device=DEVICE),
                    get_tracer(backend)(scene, camera, 1, jitter, width,
                                        height, spp, DEPTH), 1)
                step = make(m, width, height, spp, DEPTH, backend=backend)
                step.steps = EagerSteps()
                acc = torch.zeros((width * height, 4), device=DEVICE)
                path_frame(
                    f"sharded {kind} step, NCCL world of 1, {backend} "
                    f"cornell {width}x{height} spp {spp}",
                    {**{k: spp * v for k, v in per_spp.items()},
                     "all_reduce": int(kind != "tile")},
                    lambda: step(scene, camera, 1, jitter, acc), totals,
                    size)
                if kind == "tile":
                    assert bits_equal(acc, ref), f"{backend} tile step"
                else:
                    assert torch.allclose(acc, ref, rtol=2e-5, atol=2e-5), \
                        f"{backend} {kind} step not within 2e-5"
    finally:
        dist.destroy_process_group()
    print(f"sharded steps, NCCL world of 1, cornell {width}x{height} "
          f"d{DEPTH}, backends {[c[0] for c in cases]}: tile bit-equal to "
          f"the frame, sample and tile x sample within 2e-5 of it")


def main(argv: list[str]) -> int:
    if argv:
        print(f"chip_smoke: takes no arguments, got {argv}", file=sys.stderr)
        return 2
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
        if any(k in line for k in ("entry function", "registers", "spill")):
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
    tq_tables, tq_cam, tq_tex = textured_scene(glb, *hd, dev)
    print(f"textured quad: {tq_tables.valid_count} world tris (padded "
          f"{tq_tables.shade_table.shape[0]}), {tq_tables.light_count} "
          f"lights, level 0 {tuple(tq_tex[0].flat.shape)}, mip "
          f"{tuple(tq_tex[1].flat.shape)}")

    sp_world = NativeWorld("spheres")
    sp_world.update_camera(width, height)
    sp_tables = build_world_tables(sp_world, dev)
    sp_cam = torch.from_numpy(np.asarray(sp_world.camera(),
                                         np.float32)).to(dev)
    assert cuda_dense.multi_tile(sp_tables)
    print(f"spheres: {sp_tables.valid_count} world tris (padded "
          f"{sp_tables.shade_table.shape[0]}, {sp_tables.spheres.shape[0]} "
          f"tiles), {sp_tables.light_count} lights")
    bvh_cornell = build_device_scene(world, device=dev)
    bvh_sp = build_device_scene(sp_world, device=dev)
    pack_cornell = intersect.pack_walk(bvh_cornell)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pack_sp = intersect.pack_walk(bvh_sp)
    torch.cuda.synchronize()
    pack_ms = 1e3 * (time.perf_counter() - t0)
    assert int(pack_cornell.finite) == 1 and int(pack_sp.finite) == 1
    print(f"BVH scenes: cornell {bvh_cornell.node_min.shape[0]} nodes "
          f"(TLAS {bvh_cornell.tlas_count}), spheres "
          f"{bvh_sp.node_min.shape[0]} nodes (TLAS {bvh_sp.tlas_count}), "
          f"{bvh_sp.tri_v.shape[0]} tris padded; spheres' WalkPack "
          f"{sum(x.numel() * 4 for x in pack_sp[:3]) / 1e6:.1f} MB, built "
          f"in {pack_ms:.3f} ms (host clock, synchronised)")

    fm_tables, fm_cam, fm_tex = textured_scene(formats_scene_glb(), *hd, dev)
    assert fm_tex[0].shape == (4, 1024, 1024)
    assert fm_tex[1].shape == (4, 128, 128)  # 4 * 128^2 = KRON_MAX_ROWS
    fm5_tex = textured_scene(formats_scene_glb(), *hd, dev, fifth=True)[2]
    assert fm5_tex[0].shape == (5, 1024, 1024) and fm5_tex[1] is fm5_tex[0]
    lq_tables, lq_cam, lq_tex = textured_scene(textured_light_glb(), width,
                                               height, dev)
    assert lq_tables.light_tex and lq_tables.light_count > 0

    # --- phase 2: each kernel against its plain version ---
    shade_row = check_shade(tables, camera, width, height)
    shade_tex_row = check_shade_textured([
                   ("textured quad 1080p", tq_tables, tq_cam, tq_tex, *hd,
                    (0, 4)),
                   ("texture formats 1080p", fm_tables, fm_cam, fm_tex, *hd,
                    (0, 4)),
                   ("texture formats + a 5th layer (level 1 is level 0) "
                    "1080p", fm_tables, fm_cam, fm5_tex, *hd, (0,)),
                   ("textured light 512^2", lq_tables, lq_cam, lq_tex, width,
                    height, (0, 4))],
                   (tables, {hd: cam_hd, (width, height): camera}))
    results = [check_sweep(tables, camera, width, height), shade_row,
               shade_tex_row]

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
    results.append(dict(check_fetch_quad([
        ("mip 128^2, 1080p bounce rows", tq_tex[1].flat, rows1),
        ("level 0 1024^2, 1080p bounce rows", tq_tex[0].flat, rows0)]),
        path="the G-buffer pass of textured scenes (render_gbuffer)"))

    results += check_jobs(sp_tables, sp_cam, width, height)
    results += check_scan(sp_tables, sp_cam, width, height)
    results += check_bvh([
        ("cornell 512^2", bvh_cornell, pack_cornell, camera, tables),
        ("spheres 512^2", bvh_sp, pack_sp, sp_cam, sp_tables)])
    sp_world.update_camera(*hd)
    sp_cam_hd = torch.from_numpy(np.asarray(sp_world.camera(),
                                            np.float32)).to(dev)
    shade_cases = [("cornell", bvh_cornell, camera, cam_hd),
                   ("spheres", bvh_sp, sp_cam, sp_cam_hd)]
    for name, glb_data in (("textured quad", glb),
                           ("textured light", textured_light_glb())):
        sc, c_small = bvh_scene("viewer", width, height, dev, glb_data)
        shade_cases.append((name, sc, c_small, bvh_scene(
            "viewer", *hd, dev, glb_data)[1]))
    results.append(check_bvh_shade(
        [(f"{name} 512^2", sc, c_small, (width, height))
         for name, sc, c_small, _ in shade_cases]
        + [(f"{name} 1920x1080", sc, c_hd, hd)
           for name, sc, _, c_hd in shade_cases]))

    # The formats scene's 1080p primary hits, every layer in turn: the quad
    # fetch on its four-layer level 0 and mip, and the plain sampler's f64
    # fused multiply-add against a true f32 one.
    ro, rd = pinhole_rays(fm_cam, *hd)
    hit = intersect_and_shade(fm_tables, fm_tex, ro, rd)
    lane = torch.arange(hd[0] * hd[1], device=dev, dtype=torch.int32)
    layer = torch.where(hit.wt >= 0, lane % 4, -1)
    rows0 = texel_rows(fm_tex[0], layer, hit.tex_u, hit.tex_v)[0]
    rows1 = texel_rows(fm_tex[1], layer, hit.tex_u, hit.tex_v)[0]
    results.append(dict(check_fetch_quad([
        ("texture formats mip 4 x 128^2, 1080p rows", fm_tex[1].flat, rows1),
        ("texture formats level 0 4 x 1024^2, 1080p rows", fm_tex[0].flat,
         rows0)]), name="fetch_quad_4_layers",
        path="the formats scene's G-buffer pass (base colour and normal "
        "map)"))
    for name, level in (("level 0", fm_tex[0]), ("mip", fm_tex[1])):
        bad, total = fma_ties(level, layer, hit.tex_u, hit.tex_v)
        print(f"sampler fused multiply-adds, texture formats 1080p primary "
              f"hits, {name}: the plain version's f64 emulation rounds {bad} "
              f"of {total} otherwise than a true f32 fma (one ulp each)")

    results.append(check_present([PRESENT_SIZE, hd]))

    # --- phase 3: one frame of every path and its present, counting
    # launches ---
    totals = dict.fromkeys(kernels.launches, 0)
    small = (width, height)
    dense_col, _ = path_frame("cornell 512^2 traced", row_launches(),
                              lambda: dense_frame(small, tables, camera),
                              totals, small)
    traced_hd, _ = path_frame("cornell 1080p traced", row_launches(),
                              lambda: dense_frame(hd, tables, cam_hd),
                              totals, hd)
    seeded_hd, _ = path_frame("cornell 1080p G-buffer seeded",
                              row_launches(seeded=True),
                              lambda: dense_frame(hd, tables, cam_hd,
                                                  seeded=True), totals, hd)
    assert bits_equal(seeded_hd, traced_hd), \
        "cornell 1080p: seeded frame 1 differs from the traced frame 1"
    textured_shades = path_frame(
        "textured quad 1080p traced", row_launches(),
        lambda: dense_frame(hd, tq_tables, tq_cam, tq_tex),
        totals, hd)[1]["shade_rows"]
    tq_small = textured_scene(glb, width, height, dev)
    textured_shades += path_frame(
        "textured quad 512^2 G-buffer seeded",
        row_launches(seeded=True, quads=1),
        lambda: dense_frame(small, *tq_small, seeded=True),
        totals, small)[1]["shade_rows"]
    twin = textured_scene(formats_scene_glb(twin=True), *hd, dev)
    for seeded in (False, True):
        want = row_launches(seeded=seeded, quads=2 * seeded)
        tag = " G-buffer seeded" if seeded else ""
        pair = []
        for name, scene in (("texture formats", (fm_tables, fm_cam,
                                                 fm_tex)),
                            ("texture formats twin (8-bit PNGs)", twin)):
            col, counts = path_frame(
                f"{name} 1080p{tag}", want,
                lambda: dense_frame(hd, *scene, seeded=seeded), totals,
                hd)
            pair.append(col)
            textured_shades += counts["shade_rows"]
            if seeded and name == "texture formats":
                formats_quads = counts["fetch_quad"]
        assert bits_equal(*pair), f"texture formats 1080p{tag}: frame 1 " \
            "differs from the twin's"
    jobs_sp, _ = path_frame("spheres 512^2 traced", row_launches(
        multi_tile=True), lambda: dense_frame(small, sp_tables, sp_cam),
        totals, small)
    scan_sp, _ = path_frame("spheres 512^2 traced narrow=scan", row_launches(
        multi_tile=True, narrow="scan"), lambda: dense_frame(
            small, sp_tables, sp_cam, narrow="scan"), totals, small)
    assert bits_equal(scan_sp, jobs_sp), \
        "spheres 512^2: the scan path's frame 1 differs from the job path's"
    jitter = torch.zeros(2, device=dev)
    bvh_col, _ = path_frame("cornell 512^2 BVH", BVH_LAUNCHES,
                            lambda: trace_pixels(bvh_cornell, camera, 1,
                                                 jitter, width, height, 1,
                                                 DEPTH), totals, small)
    path_frame("spheres 512^2 BVH", BVH_LAUNCHES, lambda: trace_pixels(
        bvh_sp, sp_cam, 1, jitter, width, height, 1, DEPTH), totals, small)
    close = float(torch.isclose(bvh_col, dense_col, rtol=1e-3, atol=1e-3)
                  .all(1).float().mean())
    assert close > 0.98, f"cornell 512^2: BVH and dense frames agree on " \
        f"{close:.4f} of the lanes"
    sharded_steps((("bvh", bvh_cornell, camera),
                   ("dense", (tables, None), camera)), small, totals)
    print(f"paths: cornell 1080p seeded frame 1 bit-equal to traced; the "
          f"texture formats 1080p frames (traced, seeded) bit-equal to the "
          f"twin's; spheres 512^2 narrow=scan frame 1 bit-equal to "
          f"narrow=jobs; cornell 512^2 BVH and dense frames agree on "
          f"{close:.4f} of the lanes (1e-3); launches in all: {totals}")

    # Every shade of a textured scene ran the textured instantiation.
    shade_tex_row["launches"] = textured_shades
    shade_row["launches"] = totals["shade_rows"] - textured_shades
    for res in results:
        if res["name"] == "fetch_quad_4_layers":
            res["launches"] = formats_quads
        elif "launches" not in res:
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
