#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, render.

Run from the repository root with no arguments:

    python3 chip_smoke.py            # add --profile for a torch.profiler
                                     # device-time split of each path
    python3 chip_smoke.py --frame-times   # only frame times and digests
                                          # of six paths (see frame_times;
                                          # --profile adds the BVH paths')
                                          # launches and busy share)

It builds the port's CUDA kernels from `webgpu_raytracer_tpu_torch/csrc/`
(and the shared native scene compiler), then:

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it, and times kernel, plain version and, where
   one exists, the PyTorch library call that computes the same function:
   the sweep at cornell 512^2, bit-equal to its plain versions (t, idx,
   rows from lanes 0, R and 2R, occlusion, from two launches each) on a
   synthetic fused stack and on the real bounce-1 stack, timed with rows,
   without rows and any-hit on both; the shade kernel's white-texel
   instantiation at cornell 512^2 bounces 0 and 4, and its textured one
   with the scene's pyramid on the textured quad's 1080p bounces 0 and 4,
   the formats scene's (four layers), the formats scene with a fifth layer
   (so level 1 is level 0) and a quad light with a textured base colour
   (NEE reads the light's texels), timed beside its byte bound and beside
   the white-texel kernel at the same lane count;
   the row fetch on
   cornell's shade table with the 1080p G-buffer's wt_idx and on the light
   rows with a bounce's light pick; the quad fetch on the textured quad's
   level-0 table and its mip with the rows of a 1080p bounce; the
   job-stream path's cull and narrow-phase kernels on the fused bounce-1
   sweep of `spheres` 512^2 (524,288 lanes over 2,009 tiles), the narrow
   phase bit-equal to the sweep kernel walking every tile; the scan path's
   keyed cull and scan kernel on the same sweep (512 ray tiles of 1,024
   lanes), bit-equal to that walk too, with the exact and the cone cull.
   Both culls are held to their plain versions on all 524,288 lanes
   (counts, survivors in ascending id, keys bit for bit), and again on a
   stack whose first group is half dead and on one that is all dead.
   Culls and narrow-phase kernels are launched twice and must repeat
   themselves bit for bit (the culls' warps merge through shared-memory
   atomics, the sweeps' lane queues fill in an order that varies), and the
   tiles and (lane, tile) pairs the sweeps report walking must equal the
   plain count. The BVH walk (`csrc/bvh_walk.cu`), closest and any-hit,
   bit-equal to its plain walk on the same tensors (t, tri, inst, the
   occluded flag, the nodes and triangles each lane visited), twice, on
   cornell's and `spheres`' 512^2 primaries and bounce-1 rays, and on the
   primaries with every 3rd lane given NaN or inf in o, d or t_max (the
   kernel's exact slab test beside its fast one), over the scene's
   `WalkPack`, built once for these checks. The BVH bounce kernel
   (`csrc/bvh_shade.cu`, over the scene's `ShadePack`) against
   `bvh_shade_step` on cornell, the textured quad, the textured light and
   `spheres` at 512^2 and 1920x1080, bounces 0 and 4: rng words equal,
   flags equal on every lane, values within rtol 1e-4 (near-mirror GGX
   lanes 5e-2); its back-to-back graph time cross-checked against the
   profiler's own device time a launch.
   Each kernel's time is `kernel_ms`: 200 calls of its wrapper captured in
   one CUDA graph and replayed between a pair of CUDA events, so the host's
   cost of the calls is not in it, each call after a 256 MB read that
   empties the L2 (the graph of the reads alone subtracted), so a call
   moves its bytes through memory as the bound counts them; beside it the
   same calls back to back (L2 warm), the host-paced time of the calls
   made from Python (`device_ms`, the slower of device and host) and the
   wrapper's host us a call. Plain versions and whole paths are
   host-paced;
2. drives every path of the port with the launch counts set to 0 just
   before it and read just after, and asserts each kernel's exact count:
   - cornell 512^2 d8 x 32 and 1920x1080 d8 x 8 (`trace_pixels_dense`, the
     row-state loop: 1 + 8 sweeps and 8 shades a frame), each mean within
     2% of bench.py's golden;
   - `Renderer("cornell", 512x512, d8)`: `render_frame()` + `present()`
     x 16 (each `Renderer` frame and present one CUDA graph replay);
   - the textured quad GLB (bench.py's config 3) at 1920x1080 d8 x 8 through
     the row-state loop with the textured shade kernel (9 sweeps and 8
     shades a frame, no row or quad fetch), mean within 2% of 0.2739, from
     a texture decoded without PIL and checked to be red and blue;
   - texture formats: every JPEG of `tests/fixtures/torch_textures/`
     decodes to Pillow's digest (`digests.json` there; this machine needs
     no Pillow), the PNGs written here (16-bit RGB Adam7, 4-bit palette)
     to their pixels; host ms of `decode_texture` on a 2048^2 JPEG, a
     2048^2 16-bit Adam7 PNG and the 8-bit PNG of the same pixels, and of
     `build_quad_pyramid`; the formats scene (the quad with four texture
     slots in four formats) at 1920x1080 d8 through `Renderer` x 8 traced
     and x 4 G-buffer seeded, every frame bit-equal to its twin of 8-bit
     PNGs of the port's decodes (both counted; the seeded frames' G-buffer
     pass launches the quad fetch, base colour and normal map); the quad
     fetch on its four-layer level 0 and mip with the
     rows of a 1080p primary hit, one layer a lane in turn, bit-equal to
     its plain version and timed beside `index_select`;
   - G-buffer-seeded cornell 1920x1080 d8 x 8, mean within 2% of 0.1766,
     frame 1 bit-equal to the traced frame 1;
   - the textured `Renderer` at 512^2 d8, `render_frame(use_gbuffer=True)`
     + `present()` x 8 (the G-buffer's quad fetch, one seed-row fetch,
     then the row-state loop);
   - `spheres` (257,136 triangles) 512^2 d8 x 4 (`trace_pixels_dense`:
     1 + 8 culls and job sweeps and 8 shades a frame, no dense sweep),
     mean within 2% of bench.py's golden, then `Renderer("spheres",
     512x512, d8)`: `render_frame()` + `present()` x 4;
   - `spheres` 512^2 d8 x 4 through `trace_pixels_dense(narrow="scan")`
     (1 + 8 keyed culls and scan sweeps and 8 shades a frame, no job sweep
     and no dense sweep), the same golden, frame 1 bit-equal to the job
     path's, then `Renderer("spheres", narrow="scan")` x 4;
   - the BVH path (`trace_pixels`: a shade, a shadow walk and a closest
     walk a bounce, no closest walk after the last) on cornell 512^2 d8
     x 32 and `spheres` 512^2 d8 x 4, the same goldens, ms/frame beside
     the dense path's;
     `get_tracer("bvh")` and `get_tracer("dense")` on one cornell frame;
   - the sharded steps (`ShardedStep`, parallel/sharding.py): a world of
     one NCCL rank runs the tile (spp 1), sample and 2-D (spp 2, a 1 x 1
     mesh) steps on cornell 512^2 d8 on both backends, cornell 1920x1080
     d8 and `spheres` 512^2 d8 on "bvh" (`SHARD_CELLS`), each eager /
     graph / graph / eager in this process over frames 1..n (the graph:
     one CUDA graph a step, the all-reduce recorded in it): every frame's
     accumulator bit-equal across the arms, the tile step bit-equal to
     the tracer + `accumulate`, the others within 2e-5, the goldens, exact
     launches; prints ms a step, capture ms, pool MB and launches a
     replay. Then two gloo ranks in subprocesses share the card
     (`--shard-rank`, an internal option), each running its tile step
     (one graph) and sample step (two graphs, gloo's all-reduce between
     them) eager and captured over 3 frames: captured bit-equal to eager,
     the bands bit-equal to the frame, the sample frames within 2e-5 and
     the same on both ranks;
   - the compiled frame steps: every `Renderer` cell (cornell 512^2 and
     1080p, the textured quad 512^2 G-buffer seeded, the formats scene
     1080p, `spheres` 512^2 through both narrow phases, and cornell 512^2
     on the BVH path, `render_step(backend="bvh")`) runs n x
     (`render_frame` + `present`) four times on one Renderer, with its
     steps eager (`EagerSteps`), captured (`CapturedSteps`: a CUDA graph
     a step key), captured, eager: every frame's accumulator, image and
     ray count bit-equal across the four, the launch counts exact in each,
     two captures in each captured run (three past frame 16: the present
     without the un-jitter resample); then `present_step`'s device ms at
     512^2 and 1080p with and without the resample; prints ms/frame, frame
     1's ms,
     capture ms, the graphs' pool MB and a JSON line of all of it. Every
     other `Renderer` run of the script (the cells above, the animated
     tick, the resume, the recorder, the farm, the CLI) goes through
     captured steps; the animated tick's reuploads of equal shapes
     capture nothing;
3. drives the product surface on the card, with exact launch counts
   where one process renders alone:
   - bench.py's config 4: the skinned strip GLB (2 triangles) at 512^2 d8,
     24 frames through the `WorldBridge` overlap (the next tick on the
     bridge's thread while the frame renders), every frame bit-equal to a
     second `Renderer` ticked sequentially; prints fps, the sequential
     tick's split (native update, `reupload_scene`, render, each ending in
     a sync) and the fps of `update_scene(t)` + render with no sync;
   - bench.py --soak's check at 16 spp: cornell 1920x1080 d8, 8 frames,
     `save_checkpoint`, `load_checkpoint` into a fresh `Renderer`, 8
     frames, bit-identical to 16 uninterrupted frames; prints spp/s;
   - `VideoRecorder.record_chunks` at `RenderConfig()`'s record defaults
     (720x480, depth 10, spp 64), cornell, 3 frames; the PNGs decode (the
     port's own decoder) and are not black;
   - the render farm on one card: a `Coordinator` and two
     `WorkerClient(device="cuda")` threads, cornell 720x480 d10 spp 4, 4
     frames in jobs of 2, byte-equal to a solo `record_chunks` (two workers
     share the launch counts, so none are asserted);
   - `python -m webgpu_raytracer_tpu_torch.cli render` (720x480, 16
     frames, live preview on) and `info` in subprocesses, exit 0, the PNG
     decodes; the preview's `publish` of a 720x480 frame, timed;
4. prints the card's name and power limit, one JSON line of per-kernel
   results, and last `{"ok": true, "device": {...}}`.

Every check is an assert; there is no fallback. Without CUDA it exits
non-zero before printing any result. It imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import (cuda_dense, cuda_fetch, cuda_jobs,
                                            cuda_scan, intersect, shade_rows)
from webgpu_raytracer_tpu_torch.ops.api import get_tracer
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
from webgpu_raytracer_tpu_torch.ops.tune import M_TILE2, M_TILE3
from webgpu_raytracer_tpu_torch.ops.dense_trace import (
    BASE, EMISSIVE, METAL_ROUGH, NORMAL, bounce_inputs, bounce_rays,
    intersect_and_shade, pinhole_rays, texel_rows, trace_pixels_dense)
from webgpu_raytracer_tpu_torch.ops.fetch import (device_pyramid,
                                                  fetch_quad_plain,
                                                  fetch_rows_plain)
from webgpu_raytracer_tpu_torch.ops.gbuffer import render_gbuffer
from webgpu_raytracer_tpu_torch.ops.intersect import T_MIN
from webgpu_raytracer_tpu_torch.ops.rng import init_rng, rand_n
from webgpu_raytracer_tpu_torch.ops.trace import (accumulate, load_hit,
                                                  trace_pixels)
from webgpu_raytracer_tpu_torch.parallel import sharding
from webgpu_raytracer_tpu_torch.parallel.cluster import (
    Coordinator, WorkerClient, _default_renderer_factory)
from webgpu_raytracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
from webgpu_raytracer_tpu_torch.render.preview import PreviewServer
from webgpu_raytracer_tpu_torch.render.recorder import VideoRecorder
from webgpu_raytracer_tpu_torch.render.resources import build_device_scene
from webgpu_raytracer_tpu_torch.render.worldtris import (SHADE_COLS,
                                                         build_world_tables)
from webgpu_raytracer_tpu_torch.utils.images import jpeg_rgb, png_rgb
from webgpu_raytracer_tpu_torch.utils.jpeg import decode_jpeg
from webgpu_raytracer_tpu_torch.utils.profiling import synchronize
from webgpu_raytracer_tpu_torch.utils.textures import (build_quad_pyramid,
                                                       decode_png,
                                                       decode_texture,
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
ANIM_FRAMES = 24  # bench.py's anim_pass window (config 4)
SOAK_FRAMES = 16  # the checkpoint resume: 8, save, load, 8 against 16
FRAME_MS = {}  # path -> (ms/frame, Mrays/s) of frames 2..n in this run


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


def pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((4 - len(b) % 4) % 4)


def glb(doc: dict, blobs: list[bytes]) -> bytes:
    """A GLB container: the JSON chunk, then the binary chunk holding
    `blobs` each padded to 4 bytes (doc's bufferViews must match)."""
    js = pad4(json.dumps(doc).encode(), b" ")
    bin_data = b"".join(pad4(b) for b in blobs)
    total = 12 + 8 + len(js) + 8 + len(bin_data)
    return (struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_data), 0x004E4942) + bin_data)


def quad_glb(images: list[tuple[bytes, str]], material: dict) -> bytes:
    """The textured quad's geometry (a unit quad at y = 1, normals +z,
    UVs over [0, 1]^2) with `images` ((bytes, mimeType) each, texture i
    reading image i) and one `material`."""
    positions = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blobs = [positions.tobytes(), normals.tobytes(), uvs.tobytes(),
             indices.tobytes()] + [data for data, _ in images]
    offsets = np.cumsum([0] + [len(pad4(b)) for b in blobs[:-1]]).tolist()
    bin_data = b"".join(pad4(b) for b in blobs)
    views = [48, 48, 32, 12] + [len(data) for data, _ in images]
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
        "images": [{"bufferView": 4 + i, "mimeType": mime}
                   for i, (_, mime) in enumerate(images)],
        "textures": [{"source": i} for i in range(len(images))],
        "materials": [material],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3,
            "material": 0,
        }]}],
    }
    return glb(doc, blobs)


def textured_quad_glb() -> bytes:
    """tests/glb_fixture.textured_quad_glb without PIL: the same quad and
    the same 8x8 image, left half red and right half blue, as a PNG
    baseColorTexture."""
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = [255, 0, 0]
    img[:, 4:] = [0, 0, 255]
    return quad_glb([(png_rgb(img), "image/png")], {
        "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0,
        },
    })


def textured_light_glb() -> bytes:
    """The quad as a light (emissiveFactor 1) whose base colour is a
    37x53 texture of smooth noise: NEE samples read the light's texture."""
    img = smooth_noise(37, 53, 3, 5).astype(np.uint8)
    return quad_glb([(png_rgb(img), "image/png")], {
        "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "baseColorTexture": {"index": 0},
        },
        "emissiveFactor": [1.0, 1.0, 1.0],
    })


def textured_scene(glb_data: bytes, width: int, height: int, dev,
                   fifth: bool = False) -> tuple:
    """(tables, camera, texture pyramid) of a GLB in the viewer scene.
    fifth=True adds a fifth layer (the first with its channels reversed),
    so that k * 128^2 > KRON_MAX_ROWS and level 1 is level 0."""
    world = NativeWorld("viewer", glb_data=glb_data)
    world.update_camera(width, height)
    tables = build_world_tables(world, dev)
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    decoded = decode_world_textures(world)
    if fifth:
        decoded = np.concatenate([decoded, decoded[:1, ..., ::-1]])
    return tables, camera, device_pyramid(build_quad_pyramid(decoded), dev)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # (x0, y0, dx, dy)


def png_bytes(px, color_type: int, filters=(0,), palette=None,
              depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG of (H, W, C) samples below 2^depth, written without PIL.

    Samples are packed at `depth` bits (MSB first below 8 bits, big-endian
    at 16), each row byte-padded; with interlace 1 the image goes as the
    seven Adam7 passes, each a sub-image with its own filtered rows (a pass
    with no columns or rows writes nothing). Row y of a pass takes filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    over bytes, `bpp` = max(1, C * depth // 8) apart."""
    px = np.asarray(px, np.int64)
    h, w, c = px.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(
                np.uint8)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(sub.shape[0], -1)
        else:
            bits = (sub.reshape(sub.shape[0], -1, 1)
                    >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(sub.shape[0], -1).astype(
                np.uint8), axis=1)
        rows = rows.astype(np.int64)
        prior = np.zeros(rows.shape[1], np.int64)
        zero = np.zeros(bpp, np.int64)
        for y, cur in enumerate(rows):
            left = np.concatenate([zero, cur[:-bpp]])[:cur.size]
            upleft = np.concatenate([zero, prior[:-bpp]])[:cur.size]
            f = filters[y % len(filters)]
            if f == 0:
                pred = 0
            elif f == 1:
                pred = left
            elif f == 2:
                pred = prior
            elif f == 3:
                pred = (left + prior) >> 1
            else:
                p = left + prior - upleft
                pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                              np.abs(p - upleft))
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prior, upleft))
            raw += bytes([f]) + ((cur - pred) & 0xFF).astype(
                np.uint8).tobytes()
            prior = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + chunk(b"IEND", b"")


def skinned_strip_glb() -> bytes:
    """tests/glb_fixture.skinned_strip_glb, the same bytes: a 2-bone
    skinned vertical strip (2 triangles), its top bound to a joint that
    one clip, 'sway', moves +x over a second (bench.py's config 4)."""
    positions = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    joints = np.array(
        [[0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.uint16)
    weights = np.array(
        [[1, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    indices = np.array([0, 1, 3, 0, 3, 2], np.uint16)
    ibm = np.stack([np.eye(4, dtype=np.float32),
                    np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                              [0, -1, 0, 1]], np.float32)])
    times = np.array([0.0, 1.0], np.float32)
    trans = np.array([[0, 1, 0], [1, 1, 0]], np.float32)
    blobs = [a.tobytes() for a in (positions, joints, weights, indices, ibm,
                                   times, trans)]
    offsets = np.cumsum([0] + [len(pad4(b)) for b in blobs[:-1]]).tolist()

    def acc(view, ctype, count, atype):
        return {"bufferView": view, "componentType": ctype, "count": count,
                "type": atype}

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"name": "root_joint", "children": [2]},
            {"name": "mesh_node", "mesh": 0, "skin": 0},
            {"name": "tip_joint", "translation": [0, 1, 0]},
        ],
        "buffers": [{"byteLength": sum(len(pad4(b)) for b in blobs)}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": len(b)}
                        for o, b in zip(offsets, blobs)],
        "accessors": [acc(0, 5126, 4, "VEC3"), acc(1, 5123, 4, "VEC4"),
                      acc(2, 5126, 4, "VEC4"), acc(3, 5123, 6, "SCALAR"),
                      acc(4, 5126, 2, "MAT4"), acc(5, 5126, 2, "SCALAR"),
                      acc(6, 5126, 2, "VEC3")],
        "skins": [{"joints": [0, 2], "inverseBindMatrices": 4}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "JOINTS_0": 1, "WEIGHTS_0": 2},
            "indices": 3,
        }]}],
        "animations": [{
            "name": "sway",
            "channels": [{"sampler": 0,
                          "target": {"node": 2, "path": "translation"}}],
            "samplers": [{"input": 5, "output": 6,
                          "interpolation": "LINEAR"}],
        }],
    }
    return glb(doc, blobs)


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


def fma_rounding(a, b, c) -> tuple:
    """a * b + c of f32 tensors: (rounded through f64 as the plain
    sampler's `_fma_v3` rounds it, rounded once as one f32 fused
    multiply-add). a * b is exact in f64 and TwoSum gives the f64 sum's
    error e, so the two part only where the sum lands on the midpoint of
    two f32 values with e != 0: the true fma rounds toward e's side, the
    f64 path to the even neighbour, one ulp apart."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.inf, -torch.inf).to(torch.float32)
    n = torch.nextafter(r, toward)
    mid = (d != 0) & (r.double() + n.double() == 2.0 * s)
    up = mid & (e != 0) & ((e > 0) == (d > 0))
    return r, torch.where(up, n, r)


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


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the entries that differ; 0.0 when a == b
    everywhere (equal infinities, NaN against NaN and the 3e38 of a dropped
    cluster included)."""
    a, b = a.double(), b.double()
    same = (a == b) | (a.isnan() & b.isnan())
    return float(torch.where(same, 0.0, (a - b).abs()).max())


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two 32-bit tensors (f32 compared as int32 words)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


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


def poison_lanes(ro, rd, t_max, seed: int):
    """Copies of a stack with every 3rd lane given NaN, +inf or -inf in one
    component of o or of d, or in t_max (a float t_max becomes per lane)."""
    R, dev = ro.shape[0], ro.device
    rs = np.random.default_rng(seed)
    ro, rd = ro.cpu().numpy().copy(), rd.cpu().numpy().copy()
    tm = (t_max.cpu().numpy().copy() if isinstance(t_max, torch.Tensor)
          else np.full(R, t_max, np.float32))
    bad = np.arange(0, R, 3)
    what = rs.integers(0, 7, bad.size)  # 0-2 o, 3-5 d, 6 t_max
    val = np.array([np.nan, np.inf, -np.inf], np.float32)[
        rs.integers(0, 3, bad.size)]
    for k in range(3):
        ro[bad[what == k], k] = val[what == k]
        rd[bad[what == k + 3], k] = val[what == k + 3]
    tm[bad[what == 6]] = val[what == 6]
    return tuple(torch.from_numpy(x).to(dev) for x in (ro, rd, tm))


def walk_bit_equal(scene, ro, rd, t_max, active, any_hit, label,
                   pack) -> tuple:
    """The kernel twice (over `pack`) and the plain walk once on the same
    CUDA tensors: results and counts bit for bit. Returns (kernel out,
    stats, measured error): the largest |t - t_plain| of the closest walk,
    or of the occluded flags as 0 / 1 in any-hit mode, over both
    launches."""
    runs = [intersect.walk_cuda(scene, ro, rd, T_MIN, t_max, active,
                                any_hit, True, pack) for _ in range(2)]
    plain, pst = intersect.traverse_plain(scene, ro, rd, T_MIN, t_max,
                                          active, any_hit)
    torch.cuda.synchronize()
    want = (plain, *pst) if any_hit else (*plain, *pst)
    for out, st in runs:
        got = (out, *st) if any_hit else (*out, *st)
        for a, b in zip(got, want):
            assert bits_equal(a, b), f"bvh walk {label}: kernel != plain"

    def first(x):  # the occluded flags, or the closest walk's t
        return x if any_hit else x.t

    err = max(max_abs_diff(first(out), first(plain)) for out, _ in runs)
    out, st = runs[0]
    frac = float((out if any_hit else out.inst_idx >= 0).float().mean())
    print(f"bvh walk {label}: {'occluded' if any_hit else 'hit'} "
          f"{frac:.4f} of {ro.shape[0]} lanes, nodes visited "
          f"{float(st.nodes.float().mean()):.2f} a lane (max "
          f"{int(st.nodes.max())}), triangles tested "
          f"{float(st.tris.float().mean()):.2f}; bit-equal to the plain "
          f"walk (t, tri, inst / occluded, counts), two launches, max abs "
          f"err {err}")
    return out, st, err


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


def bvh_launches(depth: int = DEPTH, spp: int = 1) -> dict:
    """Per BVH frame (`trace_pixels`): the primary and depth - 1 extension
    walks, depth shades and depth shadow walks, a sample each; no other
    kernel."""
    counts = {k: 0 for k in kernels.launches}
    counts.update(bvh_closest=spp * depth, bvh_shadow=spp * depth,
                  bvh_walk=2 * spp * depth, bvh_shade=spp * depth)
    return counts


def bvh_scene(name: str, width: int, height: int, dev,
              glb_data: bytes | None = None) -> tuple:
    """(DeviceScene, camera) of a preset, or of a GLB in the viewer scene
    with its textures decoded into the level-0 quad table."""
    world = NativeWorld(name, glb_data=glb_data)
    world.update_camera(width, height)
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    return build_device_scene(world, textures=decode_world_textures(world),
                              device=dev), camera


def shade_kw(scene) -> dict:
    """`bvh_shade`'s keywords for a CUDA scene: its ShadePack, built once,
    where the checkout has one (--frame-times also runs from checkouts
    older than the pack); none on the CPU, where the pack is not read."""
    from webgpu_raytracer_tpu_torch.ops import bvh_shade

    if scene.tri_v.device.type != "cuda" or not hasattr(bvh_shade,
                                                         "pack_shade"):
        return {}
    return {"pack": bvh_shade.pack_shade(scene)}


def bvh_bounce_inputs(scene, camera, width, height, depth: int,
                      pack=None, kw=None) -> tuple:
    """`bvh_shade`'s arguments entering bounce `depth` of a BVH frame of
    depth DEPTH: `pinhole_rays` and frame 1's rng streams past the lens
    draws, advanced through the shade kernel and the walks on the card
    (their plain versions on the CPU), as `ray_color_rows` advances them.
    `pack` is the walks' WalkPack, `kw` the shade's (`shade_kw`)."""
    from webgpu_raytracer_tpu_torch.ops import bvh_shade

    kw = shade_kw(scene) if kw is None else kw

    ro3, rd3 = pinhole_rays(camera, width, height)
    ro = torch.stack(list(ro3), 1).contiguous()
    rd = torch.stack(list(rd3), 1).contiguous()
    R = width * height
    rng, _ = rand_n(init_rng(torch.arange(R, device=ro.device), 1), 2)
    hit = intersect.intersect_closest(scene, ro, rd, pack=pack)
    state = bvh_shade.initial_state(R, ro.device)
    active = occluded = None
    for d in range(depth):
        state, rng, nxt = bvh_shade.bvh_shade(
            scene, state, rng, ro, rd, active, hit.tri_idx, hit.inst_idx,
            occluded, d, DEPTH, **kw)
        occluded = intersect.intersect_shadow(
            scene, nxt.sro, nxt.srd, nxt.s_tmax, active=nxt.nee_lane,
            pack=pack)
        ro, rd, active = nxt.ro, nxt.rd, nxt.do_next
        hit = intersect.intersect_closest(scene, ro, rd, active=active,
                                          pack=pack)
    return (scene, state, rng, ro, rd, active, hit.tri_idx, hit.inst_idx,
            occluded, depth, DEPTH)


def near_mirror(args) -> torch.Tensor:
    """Lanes that sample GGX near its roughness floor (a metal whose
    roughness is under 0.01, or scaled by a texture), where
    `1 + (a*a - 1) * r2` cancels and an ulp of sin / cos moves the pdf."""
    scene, tri = args[0], args[6]
    t = tri.clamp(0, scene.tri_v.shape[0] - 1).long()
    return (scene.tri_mat[t] == 1) & ((scene.tri_mrir[t, 1] < 0.01)
                                      | (scene.tri_tex[t, 1] >= 0))


def hold_bvh_shade(label: str, args: tuple) -> float:
    """The BVH shade kernel against `bvh_shade_step` on one bounce's
    inputs: rng words equal; the flags (specular, pend, do_next, nee_lane)
    equal on every lane; every other output (state rows, rays, t_max)
    within rtol 1e-4 / atol 1e-5 on every lane but near-mirror GGX ones,
    held at 5e-2. Returns the largest |error| outside the near-mirror
    lanes."""
    from webgpu_raytracer_tpu_torch.ops import bvh_shade

    out_k, rng_k, nxt_k = bvh_shade.bvh_shade(*args)
    out_p, rng_p, nxt_p = bvh_shade.bvh_shade_step(*args)
    torch.cuda.synchronize()
    assert torch.equal(rng_k, rng_p), f"{label}: rng words differ"
    flag_rows = list(bvh_shade.FLAG_ROWS)
    flags = ((out_k[flag_rows] == out_p[flag_rows]).all(0)
             & (nxt_k.do_next == nxt_p.do_next)
             & (nxt_k.nee_lane == nxt_p.nee_lane))
    rows = [r for r in range(bvh_shade.NS) if r not in flag_rows]

    def values(out, nxt):  # (K, R) of every non-flag output
        return torch.cat([out[rows], nxt.ro.T, nxt.rd.T, nxt.sro.T,
                          nxt.srd.T, nxt.s_tmax[None]])

    vk, vp = values(out_k, nxt_k), values(out_p, nxt_p)
    assert bool(torch.isfinite(vk).all()), f"{label}: non-finite output"
    mirror = near_mirror(args)
    close = torch.isclose(vk, vp, rtol=1e-4, atol=1e-5).all(0)
    close_m = torch.isclose(vk, vp, rtol=5e-2, atol=1e-5).all(0)
    held = torch.where(mirror, close_m, close)
    err = float((vk - vp).abs()[:, ~mirror].max()) if bool(
        (~mirror).any()) else 0.0
    equal = float((vk == vp).all(0).float().mean())
    found = args[7] >= 0 if args[5] is None else args[5] & (args[7] >= 0)
    mirror_held = float(close_m[mirror].float().mean()) if bool(
        mirror.any()) else 1.0
    print(f"bvh shade {label}: flags equal on "
          f"{float(flags.float().mean()):.6f} of lanes, values close on "
          f"{float(close.float().mean()):.6f} (near-mirror lanes "
          f"{int(mirror.sum())}, {mirror_held:.6f} of them at 5e-2), "
          f"bit-equal {equal:.6f}, max abs err {err:.3e}; found "
          f"{float(found.float().mean()):.3f}, nee "
          f"{float(nxt_k.nee_lane.float().mean()):.3f}, next "
          f"{float(nxt_k.do_next.float().mean()):.3f}")
    assert bool(flags.all()), f"{label}: flags differ"
    assert bool(held.all()), f"{label}: values differ"
    return err


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
    holds `name`, over n calls of fn (`profile_kernels`, as
    `profile_paths` reads a frame). Back to back, so L2 stays warm."""
    fn()
    torch.cuda.synchronize()
    events = [e for e in profile_kernels(fn, n)[0] if name in e[0]]
    count = sum(c for _, _, c in events)
    assert count == n, f"profiled {count} launches of {name}, expected {n}"
    return sum(t for _, t, _ in events) / count / 1e3


def time_bvh_shade(label: str, args: tuple, kw: dict) -> dict:
    """`bvh_shade` on one bounce's inputs: kernel_times (over the pack in
    `kw`), the byte bound and share (bound / kernel ms). Prints one line."""
    from webgpu_raytracer_tpu_torch.ops import bvh_shade

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
    import ctypes

    from webgpu_raytracer_tpu_torch.ops import bvh_shade as bs

    scene, state, rng, ro, rd, active, tri, inst, occ, depth, md = args
    dev, R = state.device, ro.shape[0]
    pack = kw["pack"]
    lanes = ((state, torch.float32, (bs.NS, R)), (rng, torch.int64, (R,)),
             (ro, torch.float32, (R, 3)), (rd, torch.float32, (R, 3)),
             (tri, torch.int32, (R,)), (inst, torch.int32, (R,)))

    def checks():
        for t, dtype, shape in lanes:
            kernels.check(t, "t", dtype, shape, dev)

    def context():
        with torch.cuda.device(dev):
            pass

    state_o, rng_o, nxt_o = outs = bs.shade_outputs(R, dev)
    p = kernels.ptr

    def launch():
        kernels.library().wrt_bvh_shade(
            ctypes.addressof(pack.view), int(pack.textured), p(state),
            p(rng), p(ro), p(rd), p(active), p(tri), p(inst), p(occ), depth,
            md, R, p(state_o), p(rng_o), *(p(t) for t in nxt_o),
            kernels.stream(dev))

    res = {}
    for name, fn in (("checks", checks),
                     ("allocations", lambda: bs.shade_outputs(R, dev)),
                     ("device context", context),
                     ("stream", lambda: kernels.stream(dev)),
                     ("ctypes launch", launch),
                     ("wrapper", lambda: bs.bvh_shade(*args, **kw)),
                     ("wrapper into out", lambda: bs.bvh_shade(
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
    to the JSON line. Imported here, as in the functions above, so that
    --frame-times runs from a checkout older than the kernel."""
    from webgpu_raytracer_tpu_torch.ops import bvh_shade

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
    return dict(name="bvh_shade", route="cuda",
                source="webgpu_raytracer_tpu_torch/csrc/bvh_shade.cu",
                replaces="webgpu_raytracer_tpu/ops/trace.py:307",
                path="the BVH path's bounces (trace_pixels, get_tracer"
                "(\"bvh\"), the sharded steps)",
                max_abs_err=worst, library_ms=None,
                **{k: row[k] for k in ("ms", "l2_warm_ms", "host_ms",
                                       "host_us", "plain_ms", "bound_ms",
                                       "bound_by", "profiled_ms")})


def bvh_frames(scene, camera, width, height, n, golden_key) -> torch.Tensor:
    """n frames of `trace_pixels` (jitter 0, spp 1, depth 8): the golden
    mean over all n, ms/frame and Mrays/s of frames 2..n, kept in
    FRAME_MS. Returns frame 1's radiance."""
    jitter = torch.zeros(2, device=camera.device)
    means, rays = [], []

    def frame(f):
        col, r = trace_pixels(scene, camera, f, jitter, width, height, 1,
                              DEPTH, with_stats=True)
        means.append(col.mean())
        rays.append(r)
        return col

    first = frame(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(2, n + 1):
        frame(f)
    timed = float(torch.stack(rays[1:]).sum())  # synchronises
    seconds = time.perf_counter() - t0
    mean = float(torch.stack(means).mean())
    golden = GOLDENS[golden_key]
    ok = abs(mean - golden) <= GOLDEN_TOL * golden
    ms = 1e3 * seconds / (n - 1)
    FRAME_MS[f"{golden_key} bvh"] = (ms, timed / seconds / 1e6)
    print(f"{golden_key} BVH trace_pixels d{DEPTH}: {n} frames, {ms:.3f} "
          f"ms/frame and {timed / seconds / 1e6:.2f} Mrays/s over frames "
          f"2..{n} ({timed / (n - 1):.0f} rays/frame), mean {mean:.4f} vs "
          f"golden {golden} (+-{GOLDEN_TOL:.0%}) {'ok' if ok else 'FAIL'}")
    assert np.isfinite(first.cpu().numpy()).all()
    assert ok, f"{golden_key} BVH: mean {mean} outside golden {golden}"
    return first


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_scene(dev, width, height, name: str = "cornell",
                backend: str = "bvh"):
    """(scene, camera) of a preset for `get_tracer(backend)`: a DeviceScene
    for "bvh", (WorldTables, None) for "dense"."""
    world = NativeWorld(name)
    world.update_camera(width, height)
    camera = torch.from_numpy(np.asarray(world.camera(),
                                         np.float32)).to(dev)
    if backend == "dense":
        return (build_world_tables(world, dev), None), camera
    return build_device_scene(world, device=dev), camera


SHARD_SPP = 2  # samples of the sample-sharded frames
SHARD_GLOO_FRAMES = 3  # frames of each gloo rank's arms
# The sharded steps' cells on a NCCL world of one: (label, scene, size,
# backend, frames, golden key).
SHARD_CELLS = (("cornell 512^2 bvh", "cornell", SMALL, "bvh", 8,
                "cornell_512"),
               ("cornell 512^2 dense", "cornell", SMALL, "dense", 8,
                "cornell_512"),
               ("cornell 1920x1080 bvh", "cornell", HD, "bvh", 6,
                "cornell_1080p"),
               ("spheres 512^2 bvh", "spheres", SMALL, "bvh", 6,
                "spheres_512"))


def shard_reference(scene, camera, width, height, spp, n, backend):
    """The one-device frames the sharded steps are held to:
    `get_tracer(backend)` + `accumulate` over frames 1..n at jitter 0, the
    accumulator after each frame."""
    jitter = torch.zeros(2, device=camera.device)
    acc = torch.zeros((width * height, 4), device=camera.device)
    out = []
    for f in range(1, n + 1):
        col = get_tracer(backend)(scene, camera, f, jitter, width, height,
                                  spp, DEPTH)
        out.append(accumulate(acc, col, f).clone())
    return out


def shard_arm(step, arm: str, scene, camera, width: int, rows: int,
              n: int) -> dict:
    """n frames (int frame counts 1..n, jitter 0) of a sharded step into a
    fresh accumulator, with its steps eager (`EagerSteps`) or captured (a
    new `CapturedSteps`): the accumulator after each frame, ms a step over
    frames 2..n (host clock, each step ending in a synchronise), capture ms
    per key and the graphs' pool MB."""
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            EagerSteps)

    step.steps = (EagerSteps() if arm == "eager"
                  else CapturedSteps(camera.device))
    jitter = torch.zeros(2, device=camera.device)
    acc = torch.zeros((width * rows, 4), device=camera.device)
    kept, times = [], []
    for f in range(1, n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(scene, camera, f, jitter, acc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        assert out is acc, "a sharded step returned another accumulator"
        kept.append(acc.clone())
    captures = getattr(step.steps, "captures", [])
    return {"frames": kept, "ms": 1e3 * sum(times[1:]) / (n - 1),
            "first_ms": 1e3 * times[0],
            "capture_ms": [round(ms, 3) for _, ms in captures],
            "pool_mb": (step.steps.pool_bytes() / 2 ** 20
                        if arm == "graph" else 0.0)}


def all_reduce_ms(rows: int, group) -> dict:
    """Device ms of one all-reduce (SUM) of a (rows, 3) f32 tensor over
    `group`, 20 calls captured in one CUDA graph and replayed back to back
    (`kernel_ms`, L2 warm), beside a device copy of the same tensor."""
    import torch.distributed as dist

    buf = torch.rand((rows, 3), device=DEVICE)
    dst = torch.empty_like(buf)
    return {"all_reduce_ms": kernel_ms(lambda: dist.all_reduce(
                buf, op=dist.ReduceOp.SUM, group=group), 20, flush=False),
            "copy_ms": kernel_ms(lambda: dst.copy_(buf), 20, flush=False)}


def shard_cell(label, name, size, backend, n, golden_key, meshes, dev,
               totals: dict, profile: bool = False) -> dict:
    """The tile (spp 1), sample and 2-D (SHARD_SPP) steps of one cell on a
    NCCL world of one, each eager / graph / graph / eager in this process
    over frames 1..n: every frame's accumulator bit-equal across the four
    arms, the tile step's bit-equal to `get_tracer(backend)` + `accumulate`
    and the others within 2e-5 of it, the mean over the frames within 2%
    of the golden, the launches exact in every arm (a replay launches what
    an eager step does), one capture an arm. Prints ms a step for each
    arm, capture ms, pool MB and launches a replay, and the device ms of
    the all-reduce alone (`all_reduce_ms`); returns them. With profile,
    also profiles the tile step eager and captured (`profile_paths`)."""
    mesh, mesh2 = meshes
    width, height = size
    scene, camera = shard_scene(dev, width, height, name, backend)
    refs = {spp: shard_reference(scene, camera, width, height, spp, n,
                                 backend) for spp in (1, SHARD_SPP)}
    kinds = (("tile", sharding.tile_sharded_step, mesh, 1),
             ("sample", sharding.sample_sharded_step, mesh, SHARD_SPP),
             ("tile x sample", sharding.tile_sample_sharded_step, mesh2,
              SHARD_SPP))
    out = {}
    for kind, make, m, spp in kinds:
        per_frame = ({k: spp * v for k, v in bvh_launches().items()}
                     if backend == "bvh" else
                     {k: spp * v for k, v in rows_launches(False).items()})
        per_frame["all_reduce"] = int(kind != "tile")
        step = make(m, width, height, spp, DEPTH, backend=backend)
        assert not step.split, "NCCL records its all-reduce in the graph"
        arms = []
        for arm in STEP_ARMS:
            res = {}
            drive(f"sharded {kind} step, {label} {arm}", n, per_frame,
                  lambda: res.update(shard_arm(step, arm, scene, camera,
                                               width, height, n)), totals)
            assert len(res["capture_ms"]) == (arm == "graph")
            arms.append(res)
        ref = refs[spp]
        for f in range(n):
            for res in arms[1:]:
                assert bits_equal(res["frames"][f], arms[0]["frames"][f]), \
                    f"{label} {kind}: frame {f + 1} differs between arms"
            if kind == "tile":
                assert bits_equal(arms[0]["frames"][f], ref[f]), \
                    f"{label}: tile step frame {f + 1} != the frame"
            else:
                assert torch.allclose(arms[0]["frames"][f], ref[f],
                                      rtol=2e-5, atol=2e-5), \
                    f"{label} {kind}: frame {f + 1} not within 2e-5"
        acc = arms[0]["frames"][-1]
        mean = float((acc[:, :3] / acc[:, 3:4]).mean())
        golden = GOLDENS[golden_key]
        assert abs(mean - golden) <= GOLDEN_TOL * golden, \
            f"{label} {kind}: mean {mean} outside golden {golden}"
        eager = [a["ms"] for a in arms if not a["capture_ms"]]
        graph = [a for a in arms if a["capture_ms"]]
        launches = {k: v for k, v in per_frame.items() if v}
        first = " / ".join(f"{a['first_ms']:.1f}" for a in arms)
        held = "bit-equal to" if kind == "tile" else "within 2e-5 of"
        print(f"sharded {kind} step, NCCL world of 1, {label} d{DEPTH} spp "
              f"{spp}: eager {eager[0]:.3f} / {eager[1]:.3f}, graph "
              f"{graph[0]['ms']:.3f} / {graph[1]['ms']:.3f} ms a step "
              f"(frames 2..{n}; frame 1 {first} ms); capture ms "
              f"{[g['capture_ms'][0] for g in graph]}, pool "
              f"{graph[0]['pool_mb']:.1f} / {graph[1]['pool_mb']:.1f} MB, "
              f"launches a replay {launches}; the four arms' {n} frames "
              f"bit-equal, {held} the frame, mean {mean:.4f} vs golden "
              f"{golden}")
        out[kind] = {"eager_ms": eager,
                     "graph_ms": [g["ms"] for g in graph],
                     "first_ms": [a["first_ms"] for a in arms],
                     "capture_ms": [g["capture_ms"][0] for g in graph],
                     "pool_mb": [g["pool_mb"] for g in graph],
                     "launches_a_replay": launches, "mean": mean}
        if profile and kind == "tile":  # the last arm left it eager
            graph = make(m, width, height, spp, DEPTH, backend=backend)
            acc = torch.zeros((width * height, 4), device=dev)
            jitter = torch.zeros(2, device=dev)
            graph(scene, camera, n + 1, jitter, acc)  # captures
            profile_paths([
                (f"sharded tile step {label} eager",
                 lambda: step(scene, camera, n + 1, jitter, acc)),
                (f"sharded tile step {label} graph",
                 lambda: graph(scene, camera, n + 1, jitter, acc))])
            del graph
        del step, arms
        torch.cuda.empty_cache()
    out["all-reduce"] = all_reduce_ms(width * height,
                                      mesh.get_group(sharding.AXIS))
    print(f"sharding, NCCL world of 1, {label}: one all-reduce of "
          f"({width * height}, 3) f32 {out['all-reduce']['all_reduce_ms']:.4f}"
          f" ms device, a copy of it {out['all-reduce']['copy_ms']:.4f} ms "
          f"(graph of 20, back to back)")
    return out


def shard_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One gloo rank on the card (`--shard-rank`): the tile step (spp 1)
    and the sample step (SHARD_SPP) of cornell 512^2 d8, each over frames
    1..SHARD_GLOO_FRAMES eager and then captured (the tile step whole, the
    sample step as two graphs with gloo's all-reduce between them), each
    captured frame bit-equal to the eager one in this rank; the captured
    accumulators and the capture counts written to out_dir/rank<rank>.npz."""
    import datetime

    import torch.distributed as dist

    dev = torch.device(DEVICE)
    width, height = SMALL
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    scene, camera = shard_scene(dev, width, height)
    mesh = sharding.make_mesh(DEVICE)
    rows = height // world
    n = SHARD_GLOO_FRAMES
    out = {}
    for kind, make, spp, r, split in (
            ("band", sharding.tile_sharded_step, 1, rows, False),
            ("full", sharding.sample_sharded_step, SHARD_SPP, height, True)):
        step = make(mesh, width, height, spp, DEPTH)
        assert step.split == split, (kind, step.split)
        eager = shard_arm(step, "eager", scene, camera, width, r, n)
        graph = shard_arm(step, "graph", scene, camera, width, r, n)
        for f in range(n):
            assert bits_equal(graph["frames"][f], eager["frames"][f]), \
                f"rank {rank} {kind}: captured frame {f + 1} != eager"
        out[kind] = torch.stack(graph["frames"]).cpu().numpy()
        out[f"{kind}_captures"] = np.array(len(graph["capture_ms"]))
        out[f"{kind}_ms"] = np.array([eager["ms"], graph["ms"]])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def sharding_on_one_card(dev, totals: dict, profile: bool = False) -> dict:
    """The sharded steps on the card. A world of one rank on NCCL runs the
    tile, sample and 2-D steps on every cell of SHARD_CELLS (`shard_cell`:
    eager / graph / graph / eager, the all-reduce recorded in the graph);
    then two gloo ranks in subprocesses share the card (NCCL refuses two
    ranks on one device): their captured tile bands put together
    bit-equal to the frame, their captured sample-step frames (two graphs
    a step, the all-reduce between them) within 2e-5 of it and the same on
    both ranks, each captured frame bit-equal to its rank's eager one.
    Returns {cell: {kind: results}}."""
    import torch.distributed as dist

    start = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=torch.device(DEVICE, 0))
    meshes = (sharding.make_mesh(DEVICE),
              sharding.make_mesh(DEVICE, (1, 1), ("tile", "sample")))
    out = {}
    try:
        for label, name, size, backend, n, golden_key in SHARD_CELLS:
            out[label] = shard_cell(label, name, size, backend, n,
                                    golden_key, meshes, dev, totals, profile)
    finally:
        dist.destroy_process_group()
    nccl_s = time.perf_counter() - start

    width, height = SMALL
    scene, camera = shard_scene(dev, width, height)
    n = SHARD_GLOO_FRAMES
    ref = {spp: shard_reference(scene, camera, width, height, spp, n, "bvh")
           for spp in (1, SHARD_SPP)}
    with tempfile.TemporaryDirectory() as out_dir:
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank",
             str(r), "2", str(port), out_dir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"gloo rank failed:\n{log[-3000:]}"
        seconds = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                 for r in range(2)]
    for f in range(n):
        band = torch.from_numpy(np.concatenate([r["band"][f]
                                                for r in ranks]))
        assert bits_equal(band, ref[1][f].cpu()), \
            f"gloo tile bands != frame {f + 1}"
        for r in ranks:
            assert np.allclose(r["full"][f], ref[SHARD_SPP][f].cpu().numpy(),
                               rtol=2e-5, atol=2e-5), "gloo sample step"
    assert np.array_equal(ranks[0]["full"], ranks[1]["full"])
    for r in ranks:
        assert int(r["band_captures"]) == 1 and int(r["full_captures"]) == 2
    ms = {k: [r[f"{k}_ms"].tolist() for r in ranks] for k in ("band", "full")}
    print(f"sharding, two gloo ranks on the card, cornell {width}x{height} "
          f"d{DEPTH}, frames 1..{n}: tile step captured (one graph), bands "
          f"bit-equal to the frame; sample step captured as two graphs with "
          f"gloo's all-reduce between them, within 2e-5 of the frame and the "
          f"same on both ranks; each rank's captured frames bit-equal to its "
          f"eager ones; ms a step [eager, graph] by rank: tile {ms['band']}, "
          f"sample {ms['full']} ({seconds:.1f} s with both processes' "
          f"start-up)")
    print(f"sharding phase: {nccl_s:.1f} s on the NCCL world of one, "
          f"{time.perf_counter() - start:.1f} s in all")
    out["gloo, two ranks on one card"] = ms
    return out


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
    FRAME_MS[golden_key + tag] = (ms, mrays)
    print(f"{golden_key}{tag} d{DEPTH}: {n} frames, "
          f"{ms:.3f} ms/frame and {mrays:.2f} Mrays/s over frames 2..{n} "
          f"({timed / (n - 1):.0f} rays/frame), mean {mean:.4f} vs golden "
          f"{golden} (+-{GOLDEN_TOL:.0%}) {'ok' if ok else 'FAIL'}")
    assert ok, f"{golden_key}: mean {mean} outside golden {golden}"
    return first[0]


def renderer_frames(r: Renderer, n: int, label: str, per_frame: dict,
                    use_gbuffer=False, keep: list | None = None):
    """n x (render_frame + present) through the user's entry points; the
    Renderer's own launch counts must be n x per_frame. `keep` collects a
    copy of the accumulator after every frame."""
    r.render_frame(use_gbuffer=use_gbuffer)
    r.present()
    if keep is not None:
        keep.append(r.accum.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rays = 0.0
    for _ in range(n - 1):
        r.render_frame(use_gbuffer=use_gbuffer)
        img = r.present()  # copies to the host: synchronises
        if keep is not None:
            keep.append(r.accum.clone())
        rays += float(r.last_rays)
    seconds = time.perf_counter() - t0
    assert img.shape == (r.height, r.width, 3) and img.dtype == np.uint8
    assert 10 < img.mean() < 245, f"implausible image mean {img.mean()}"
    assert np.isfinite(r.radiance()).all()
    want = {k: n * v for k, v in per_frame.items()}
    assert r.launches == want, f"Renderer launches {r.launches}, not {want}"
    captures = [round(ms, 1) for _, ms in r.steps.captures]
    print(f"Renderer {label}: {n} x (render_frame + present), frames "
          f"2..{n} {1e3 * seconds / (n - 1):.3f} ms/frame, "
          f"{rays / seconds / 1e6:.2f} Mrays/s, image mean {img.mean():.2f}; "
          f"captured steps so far: {len(captures)}, ms {captures}")


STEP_ARMS = ("eager", "graph", "graph", "eager")


def bvh_renderer(dev, width: int, height: int) -> Renderer:
    """Renderer("cornell") on the BVH path (`choose_backend`'s path for
    large scenes on the CPU): its steps are `render_step(backend="bvh")`
    and `present_step`."""
    r = Renderer("cornell", config=RenderConfig(
        width=width, height=height, max_depth=DEPTH), device=dev)
    r.backend, r.tables = "bvh", None
    r.reupload_scene(reset=False)
    return r


def step_arm(r: Renderer, arm: str, n: int, use_gbuffer: bool) -> dict:
    """n x (render_frame + present) of `r` with its steps eager
    (`EagerSteps`) or captured (a new `CapturedSteps`), from a reset
    accumulation: ms of frame 1 (its captures) and the mean ms/frame of
    frames 2..n but those that captured a step (frame 17: the present
    without the un-jitter resample), each on the host clock (`present`
    copies the image to the host, so every frame ends in a synchronise),
    the capture ms and the graphs' pool MB, and a digest of every frame's
    accumulator, image and ray count."""
    # Imported here: `--frame-times` runs in checkouts without them.
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            EagerSteps)

    r.steps = EagerSteps() if arm == "eager" else CapturedSteps(r.device)
    r.reset_accumulation()
    r.launches = dict.fromkeys(r.launches, 0)
    captures = getattr(r.steps, "captures", [])
    kept, times = [], []
    torch.cuda.synchronize()
    for _ in range(n):
        before = len(captures)
        t0 = time.perf_counter()
        r.render_frame(use_gbuffer=use_gbuffer)
        kept.append((r.accum.clone(), r.present(), r.last_rays))
        times.append((time.perf_counter() - t0, len(captures) > before))
    steady = [t for t, captured in times[1:] if not captured]
    digest = hashlib.sha256()
    for acc, img, rays in kept:
        digest.update(acc.cpu().numpy().tobytes())
        digest.update(img.tobytes())
        digest.update(np.float64(float(rays)).tobytes())
    return {"first_ms": 1e3 * times[0][0],
            "ms": 1e3 * sum(steady) / len(steady),
            "capture_ms": [round(ms, 3) for _, ms in captures],
            "pool_mb": (r.steps.pool_bytes() / 2 ** 20 if arm == "graph"
                        else 0.0),
            "launches": dict(r.launches), "digest": digest.hexdigest(),
            "mean": float(img.mean())}


def compiled_steps(cells, totals: dict) -> dict:
    """The frame steps eager and captured on every `Renderer` cell, in
    turns eager / graph / graph / eager on one Renderer each: every arm's
    frames bit-equal (accumulator, image, ray count), the launch counts n
    x the path's per frame in every arm (a capture's own not counted), one
    capture per step key. Prints ms/frame, first-frame ms, capture ms,
    pool MB and launches; returns {label: [arm results]}."""
    out = {}
    for label, r, use_gbuffer, n, per_frame in cells:
        arms = []
        for arm in STEP_ARMS:
            res = {}
            drive(f"compiled steps, {label} {arm}", n, per_frame,
                  lambda: res.update(step_arm(r, arm, n, use_gbuffer)),
                  totals)
            want = {k: n * v for k, v in per_frame.items()}
            assert res["launches"] == want, (label, arm, res["launches"])
            # render_step, present_step, and from frame 17 present_step
            # without the un-jitter resample
            assert len(res["capture_ms"]) == (
                2 + (n > 16) if arm == "graph" else 0)
            arms.append(res)
            print(f"compiled steps, {label} {arm}: {res['ms']:.3f} ms/frame "
                  f"(frames 2..{n} but a capture's; frame 1 "
                  f"{res['first_ms']:.1f} ms), "
                  f"capture ms {res['capture_ms']}, pool "
                  f"{res['pool_mb']:.1f} MB, image mean {res['mean']:.2f}")
        assert len({a["digest"] for a in arms}) == 1, \
            f"{label}: the captured frames differ from the eager ones"
        eager = [a["ms"] for a in arms if a["capture_ms"] == []]
        graph = [a["ms"] for a in arms if a["capture_ms"]]
        print(f"compiled steps, {label}: eager {eager[0]:.3f} / "
              f"{eager[1]:.3f}, graph {graph[0]:.3f} / {graph[1]:.3f} "
              f"ms/frame; all four arms' {n} frames bit-equal; launches a "
              f"frame {dict((k, v) for k, v in per_frame.items() if v)}")
        out[label] = arms
    return out


def present_costs(dev) -> dict:
    """Device ms of `present_step` and of the un-jitter resample inside it
    (`unjittered_radiance`: a present past frame 16 with unjitter=True, the
    JAX package's form, computes it and selects the clean image; with
    unjitter=False, `Renderer`'s past frame 16, it skips it) at 512^2 and
    1920x1080, on random HDR inputs: `kernel_ms` of 20 back-to-back calls
    in one graph."""
    from webgpu_raytracer_tpu_torch.ops.postprocess import (
        firefly_clamp, get_radiance, unjittered_radiance)
    from webgpu_raytracer_tpu_torch.render.renderer import present_step

    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}
    for w, h in (SMALL, HD):
        acc = torch.rand((w * h, 4), device=dev, generator=gen) + 0.5
        hist = torch.rand((h, w, 3), device=dev, generator=gen)
        avg = torch.tensor([0.3 / w, -0.2 / h], device=dev)
        clean = firefly_clamp(get_radiance(acc.view(h, w, 4)))
        row = {}
        for f in (10, 17):
            frame = torch.full((), f, dtype=torch.int64, device=dev)
            row[f"present frame {f}"] = kernel_ms(
                lambda: present_step(acc, hist, frame, avg, width=w,
                                     height=h), 20, flush=False)
        row["present frame 17 unjitter=False"] = kernel_ms(
            lambda: present_step(acc, hist, frame, avg, width=w, height=h,
                                 unjitter=False), 20, flush=False)
        row["resample"] = kernel_ms(
            lambda: unjittered_radiance(clean, frame, avg), 20, flush=False)
        out[f"{w}x{h}"] = row
        print(f"present_step {w}x{h}: device "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
              + " (back-to-back graph of 20 calls)")
    return out


def sweeps(n: int, multi_tile: bool, narrow: str = "jobs") -> dict:
    """n sweeps: a dense sweep each on a single-tile scene; on a multi-tile
    one a cull and a job sweep each, or with narrow="scan" a keyed cull and
    a scan sweep each."""
    jobs = n if multi_tile and narrow == "jobs" else 0
    scan = n if multi_tile and narrow == "scan" else 0
    return {"dense_sweep": 0 if multi_tile else n, "cluster_cull": jobs,
            "job_sweep": jobs, "cluster_cull_keyed": scan, "scan_sweep": scan,
            "bvh_closest": 0, "bvh_shadow": 0, "bvh_shade": 0,
            "bvh_walk": 0, "all_reduce": 0}


def rows_launches(seeded: bool, multi_tile: bool = False,
                  narrow: str = "jobs", depth: int = DEPTH) -> dict:
    """Per frame of the row-state loop: traced, one primary sweep; seeded,
    one G-buffer sweep and one seed-row fetch; then per bounce one shade
    and one fused sweep."""
    return {**sweeps(1 + depth, multi_tile, narrow), "shade_rows": depth,
            "fetch_rows": int(seeded), "fetch_quad": 0}


def textured_launches(tables, seeded: bool) -> dict:
    """Per frame of a textured scene at max_depth > 0: the row-state loop,
    whose shade kernel samples the texels itself, and when seeded the
    G-buffer pass's quad fetches, one per bound base-colour / normal slot
    (`render_gbuffer` shades its hits through `intersect_and_shade`)."""
    s = tables.tex_slots
    return {**rows_launches(seeded, cuda_dense.multi_tile(tables)),
            "fetch_quad": int(seeded) * (int(s[BASE]) + int(s[NORMAL]))}


def drive(label: str, n_frames: int, per_frame: dict, fn,
          totals: dict) -> dict:
    """Run one path with the launch counts zeroed just before it; assert
    its exact counts, add them to the totals and return them."""
    kernels.reset_launches()
    fn()
    counts = dict(kernels.launches)
    want = {k: n_frames * v for k, v in per_frame.items()}
    assert counts == want, f"{label}: launches {counts}, expected {want}"
    print(f"launches, {label} ({n_frames} frames): {counts}")
    for k, v in counts.items():
        totals[k] += v
    return counts


FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "torch_textures")
FORMATS_DECODE = 2048  # side of the images the decode times are taken on
# emissiveFactor of the formats quad: |f|^2 = 9.7e-5 stays under the scene
# compiler's 1e-4 light threshold, so the quad is no light and its emission
# is this factor times the emissive texture.
FORMATS_EMISSIVE = 0.0057


def smooth_noise(height: int, width: int, channels: int, seed: int,
                 top: int = 255) -> np.ndarray:
    """(height, width, channels) int64 samples in [0, top]: gradients plus
    seeded noise."""
    rs = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    k = np.arange(channels)
    base = 0.5 + 0.4 * np.sin(x[..., None] / (0.01 * width + 7 * k + 5)
                              + y[..., None] / (0.013 * height + 5 * k + 3))
    noise = rs.normal(0, 0.04, base.shape)
    return np.clip(np.rint((base + noise) * top), 0, top).astype(np.int64)


def formats_images() -> list[tuple[str, bytes, np.ndarray | None]]:
    """The four images of the formats scene, in texture order (base
    colour, metallic-roughness, normal, emissive): (name, bytes, the RGB
    Pillow gives, or None where `digests.json` holds it). The JPEGs are
    the committed fixtures; the PNGs are written here."""
    out = []
    for name in ("baseline_420_odd", "progressive_420"):
        with open(os.path.join(FIXTURE_DIR, f"{name}.jpg"), "rb") as f:
            out.append((f"{name}.jpg", f.read(), None))
    normal = smooth_noise(47, 61, 3, 7, top=65535)
    out.append(("normal, 16-bit RGB Adam7 PNG 61x47",
                png_bytes(normal, 2, filters=(0, 1, 2, 3, 4), depth=16,
                          interlace=1), (normal >> 8).astype(np.uint8)))
    rs = np.random.default_rng(8)
    palette = rs.integers(0, 256, (16, 3))
    index = smooth_noise(29, 37, 1, 9, top=15)
    out.append(("emissive, 4-bit palette PNG 37x29",
                png_bytes(index, 3, filters=(0, 1, 2, 3, 4),
                          palette=palette, depth=4),
                palette[index[..., 0]].astype(np.uint8)))
    return out


def formats_glb(images: list[bytes], mimes: list[str]) -> bytes:
    """The textured quad with one image in each texture slot the scene
    compiler reads: base colour, metallic-roughness (metallicFactor 1, so
    the texture's blue channel is the metalness), normal and emissive."""
    return quad_glb(list(zip(images, mimes)), {
        "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "baseColorTexture": {"index": 0},
            "metallicFactor": 1.0,
            "roughnessFactor": 1.0,
            "metallicRoughnessTexture": {"index": 1},
        },
        "normalTexture": {"index": 2},
        "emissiveTexture": {"index": 3},
        "emissiveFactor": [FORMATS_EMISSIVE] * 3,
    })


def formats_scene_glb(twin: bool = False) -> bytes:
    """The texture formats scene; with twin=True the same scene whose four
    images are the port's decodes of them, written as 8-bit RGB PNGs."""
    images = [data for _, data, _ in formats_images()]
    if twin:
        return formats_glb([png_rgb(decode_image(d)) for d in images],
                           ["image/png"] * 4)
    return formats_glb(images, ["image/jpeg"] * 2 + ["image/png"] * 2)


def decode_image(data: bytes) -> np.ndarray:
    return decode_png(data) if data.startswith(b"\x89PNG") \
        else decode_jpeg(data)


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it, with its core count."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', '?')} (vendor "
            f"{info.get('vendor_id', '?')}, family "
            f"{info.get('cpu family', '?')}, model {info.get('model', '?')}), "
            f"{os.cpu_count()} cores")


def host_ms(fn, repeat: int = 2):
    """(fastest host ms of `repeat` calls, the last result)."""
    best, out = float("inf"), None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best, out


def decode_times(smi_line: str) -> None:
    """Host ms of `decode_texture` (decode + resize to 1024^2) on three
    FORMATS_DECODE^2 images of the same seeded pixels: a 4:4:4 baseline
    JPEG (quality 85) from the port's own writer, a 16-bit RGB Adam7 PNG
    (rows cycling through the five filters) whose high bytes are those
    pixels, and the 8-bit PNG of `png_rgb` (filter 0), the yardstick; then
    `build_quad_pyramid` of the three layers."""
    n = FORMATS_DECODE
    px16 = smooth_noise(n, n, 3, 11, top=65535)
    px = (px16 >> 8).astype(np.uint8)
    files = [("JPEG 4:4:4 q85", jpeg_rgb(px, 85)),
             ("16-bit RGB Adam7 PNG", png_bytes(
                 px16, 2, filters=(0, 1, 2, 3, 4), depth=16, interlace=1)),
             ("8-bit RGB PNG", png_rgb(px))]
    layers = []
    for label, data in files:
        ms, tex = host_ms(lambda: decode_texture(data))
        assert tex.shape == (1024, 1024, 3) and not (tex == 0.8).all(), \
            f"{label}: the decode fell back to the fill"
        layers.append(tex)
        print(f"decode_texture {label} {n}x{n} ({len(data) / 1e6:.2f} MB): "
              f"{ms:.1f} ms host")
    np.testing.assert_array_equal(layers[1], layers[2])
    ms, _ = host_ms(lambda: build_quad_pyramid(np.stack(layers)))
    print(f"build_quad_pyramid of 3 layers of 1024^2: {ms:.1f} ms host")
    print(f"(host times on {cpu_model()}, beside {smi_line}; fastest of 2 "
          f"calls; the 16-bit PNG decodes to the 8-bit PNG's texture bit "
          f"for bit)")


def texture_formats(dev, smi_line: str, totals: dict) -> tuple:
    """The texture formats phase: every JPEG fixture decodes to Pillow's
    digest and every written PNG to the pixels it holds; decode times;
    the formats scene (four texture layers: a 4:2:0 JPEG, a progressive
    JPEG, a 16-bit Adam7 PNG and a 4-bit palette PNG) at 1920x1080 d8
    through `Renderer`, 8 traced frames and then 4 G-buffer-seeded ones,
    every frame bit-equal to a twin scene whose images are the port's
    decodes as 8-bit PNGs; the quad fetch on the scene's four-layer level 0
    and mip. Returns (the quad fetch's kernel row, whose launches are the
    seeded frames' G-buffer quad fetches, the shade launches of these
    frames, the Renderer)."""
    with open(os.path.join(FIXTURE_DIR, "digests.json")) as f:
        digests = json.load(f)
    for name, want in sorted(digests.items()):
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            rgb = decode_jpeg(f.read())
        digest = hashlib.sha256(np.ascontiguousarray(rgb).tobytes())
        assert list(rgb.shape) == want["shape"], f"{name}: {rgb.shape}"
        assert digest.hexdigest() == want["sha256"], \
            f"{name}: decode differs from Pillow's"
        print(f"texture formats: {name} {rgb.shape[1]}x{rgb.shape[0]} "
              f"decodes to Pillow's digest {want['sha256'][:16]}")
    for name, data, want in formats_images():
        if want is not None:
            np.testing.assert_array_equal(decode_image(data), want,
                                          err_msg=name)
            print(f"texture formats: {name} decodes to its pixels")
    decode_times(smi_line)

    glb_formats = formats_scene_glb()
    glb_twin = formats_scene_glb(twin=True)
    cfg = RenderConfig(width=HD[0], height=HD[1], max_depth=DEPTH)
    rf = Renderer("viewer", config=cfg, glb_data=glb_formats, device=dev)
    twin = Renderer("viewer", config=cfg, glb_data=glb_twin, device=dev)
    assert rf.textures[0].shape == (4, 1024, 1024)
    assert rf.textures[1].shape == (4, 128, 128)  # 4 * 128^2 = KRON_MAX_ROWS
    assert rf.tables.tex_slots == (True, True, True, True)
    shades, formats_quads = 0, 0
    for seeded, n in ((False, 8), (True, 4)):
        per_frame = textured_launches(rf.tables, seeded)
        tag = " G-buffer seeded" if seeded else ""
        frames_f, frames_t = [], []
        for r, keep, name in ((rf, frames_f, "texture formats"),
                              (twin, frames_t, "texture formats twin "
                               "(8-bit PNGs)")):
            r.launches = dict.fromkeys(r.launches, 0)  # this run's only
            counts = drive(f"Renderer {name} 1080p{tag}", n, per_frame,
                           lambda: renderer_frames(
                               r, n, f"{name} {HD[0]}x{HD[1]} d{DEPTH}{tag}",
                               per_frame, use_gbuffer=seeded, keep=keep),
                           totals)
            shades += counts["shade_rows"]
            if r is rf:
                formats_quads += counts["fetch_quad"]
        for i, (a, b) in enumerate(zip(frames_f, frames_t)):
            assert bits_equal(a, b), f"texture formats{tag}: frame " \
                f"{i + 1} differs from the twin's"
        print(f"texture formats 1080p d{DEPTH}{tag}: mean radiance "
              f"{float(rf.radiance().mean()):.4f}; all {n} frames bit-equal "
              f"to the twin's (8-bit PNGs of the port's decodes)")

    ro, rd = pinhole_rays(rf.camera, *HD)
    hit = intersect_and_shade(rf.tables, rf.textures, ro, rd)
    lane = torch.arange(HD[0] * HD[1], device=dev, dtype=torch.int32)
    layer = torch.where(hit.wt >= 0, lane % 4, -1)  # every layer in turn
    rows0 = texel_rows(rf.textures[0], layer, hit.tex_u, hit.tex_v)[0]
    rows1 = texel_rows(rf.textures[1], layer, hit.tex_u, hit.tex_v)[0]
    row = check_fetch_quad([
        ("texture formats mip 4 x 128^2, 1080p rows",
         rf.textures[1].flat, rows1),
        ("texture formats level 0 4 x 1024^2, 1080p rows",
         rf.textures[0].flat, rows0)])
    return (dict(row, name="fetch_quad_4_layers", launches=formats_quads,
                 path="the formats scene's G-buffer pass (base colour and "
                 "normal map)"), shades, rf)


def animated_tick(dev, totals: dict) -> None:
    """bench.py's config 4 through the bridge overlap: the skinned strip at
    512^2 d8, ANIM_FRAMES frames in anim_pass' order (wait for the tick,
    upload, kick the next tick, render), each frame bit-equal to the frame
    of a second Renderer ticked sequentially (`world.update(t)`,
    `reupload_scene()`, then the render, each timed to a sync)."""
    def renderer():
        return Renderer("viewer", glb_data=skinned_strip_glb(),
                        config=RenderConfig(width=512, height=512,
                                            max_depth=DEPTH, shader_spp=1),
                        device=dev)

    over, seq = renderer(), renderer()
    for r in (over, seq):  # warm-up
        r.update_scene(0.0)
        r.render_frame()
    synchronize(dev)
    times = [(3 + k) / 30.0 for k in range(ANIM_FRAMES)]
    frames = []

    def overlap():
        over.bridge.update_async(times[0])
        for k in range(ANIM_FRAMES):
            over.bridge.wait()
            over.reupload_scene()
            if k + 1 < ANIM_FRAMES:
                over.bridge.update_async(times[k + 1])
            frames.append(over.render_frame().clone())
        synchronize(dev)

    t0 = time.perf_counter()
    drive("skinned strip 512^2 bridge overlap", ANIM_FRAMES,
          rows_launches(False), overlap, totals)
    fps = ANIM_FRAMES / (time.perf_counter() - t0)
    split = {"update": [], "upload": [], "render": []}

    def sequential():
        for k, t in enumerate(times):
            t0 = time.perf_counter()
            seq.world.update(t)
            t1 = time.perf_counter()
            seq.reupload_scene()
            synchronize(dev)
            t2 = time.perf_counter()
            seq.render_frame()
            synchronize(dev)
            split["update"].append(t1 - t0)
            split["upload"].append(t2 - t1)
            split["render"].append(time.perf_counter() - t2)
            assert bits_equal(seq.accum, frames[k]), \
                f"skinned strip frame {k}: overlap differs from sequential"

    drive("skinned strip 512^2 sequential ticks", ANIM_FRAMES,
          rows_launches(False), sequential, totals)
    # Every tick reuploads tables of the same shapes: copied into the
    # captured step's, never captured again.
    assert len(over.steps.captures) == 1 and len(seq.steps.captures) == 1

    def unsynced():  # update_scene(t) + render, one sync at the end
        for t in times:
            seq.update_scene(t)
            seq.render_frame()
        synchronize(dev)

    t0 = time.perf_counter()
    drive("skinned strip 512^2 update_scene + render", ANIM_FRAMES,
          rows_launches(False), unsynced, totals)
    seq_fps = ANIM_FRAMES / (time.perf_counter() - t0)
    ms = {k: 1e3 * float(np.mean(v)) for k, v in split.items()}
    tick = sum(ms.values())
    print(f"animated tick, skinned strip 512x512 d{DEPTH}: {ANIM_FRAMES} "
          f"frames through the bridge overlap {fps:.2f} fps, every frame "
          f"bit-equal to a sequential tick; update_scene + render with no "
          f"sync between frames {seq_fps:.2f} fps; sequential split (mean "
          f"of {ANIM_FRAMES}, each part ending in a sync): native update "
          f"{ms['update']:.3f} ms, reupload_scene {ms['upload']:.3f} ms, "
          f"render {ms['render']:.3f} ms; table upload share of a tick "
          f"{ms['upload'] / tick:.3f}")


def checkpoint_resume(dev, totals: dict) -> None:
    """bench.py --soak's check at SOAK_FRAMES spp: cornell 1920x1080 d8,
    SOAK_FRAMES frames uninterrupted against half, save_checkpoint,
    load_checkpoint into a fresh Renderer, the other half: the two
    accumulators bit-identical."""
    cfg = dict(width=HD[0], height=HD[1], max_depth=DEPTH, shader_spp=1)
    half = SOAK_FRAMES // 2
    result = {}

    def run():
        whole = Renderer("cornell", config=RenderConfig(**cfg), device=dev)
        whole.render_frame()  # warm-up at this size
        whole.reset_accumulation()
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(SOAK_FRAMES):
            whole.render_frame()
        synchronize(dev)
        result["spp_s"] = SOAK_FRAMES / (time.perf_counter() - t0)
        first = Renderer("cornell", config=RenderConfig(**cfg), device=dev)
        for _ in range(half):
            first.render_frame()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ck")
            t0 = time.perf_counter()
            save_checkpoint(path, first)
            t1 = time.perf_counter()
            resumed = Renderer("cornell", config=RenderConfig(**cfg),
                               device=dev)
            assert load_checkpoint(path, resumed), "checkpoint restore failed"
            result["save_s"], result["load_s"] = t1 - t0, \
                time.perf_counter() - t1
        assert resumed.accum.device == whole.accum.device
        for _ in range(SOAK_FRAMES - half):
            resumed.render_frame()
        assert bits_equal(resumed.accum, whole.accum), \
            "resumed accumulation differs from the uninterrupted one"

    drive("cornell 1080p checkpoint resume", 2 * SOAK_FRAMES + 1,
          rows_launches(False), run, totals)
    print(f"checkpoint resume, cornell {HD[0]}x{HD[1]} d{DEPTH}: "
          f"{SOAK_FRAMES} frames uninterrupted {result['spp_s']:.2f} spp/s; "
          f"{half} + save ({result['save_s']:.3f} s) + load into a fresh "
          f"Renderer ({result['load_s']:.3f} s) + {SOAK_FRAMES - half}: "
          f"accumulator bit-identical")


def record_defaults(dev, totals: dict) -> None:
    """VideoRecorder.record_chunks at RenderConfig()'s record defaults
    (720x480, depth 10, spp 64, fps 30) on cornell, 3 frames."""
    cfg = RenderConfig()
    rec = VideoRecorder(Renderer("cornell", config=cfg, device=dev))
    n = 3
    frames = []
    t0 = time.perf_counter()
    # 5 warm-up frames, then spp frames of 1 sample for each frame.
    drive("recorder cornell 720x480 d10 spp 64", VideoRecorder.
          TAA_WARMUP_FRAMES + n * cfg.spp,
          rows_launches(False, depth=cfg.max_depth),
          lambda: frames.extend(rec.record_chunks(cfg, 0, n)), totals)
    seconds = time.perf_counter() - t0
    assert [f.frame_index for f in frames] == list(range(n))
    # Each frame is presented once, over the TAA history its tick cleared,
    # at alpha 1/spp: the PNG holds ~1/64 of the radiance and is dark, as
    # the JAX package's recorder's is. The accumulator carries the frame.
    for f in frames:
        img = decode_png(f.data)
        assert img.shape == (cfg.height, cfg.width, 3), img.shape
        assert img.mean() > 1 and img.max() > 32, \
            f"frame {f.frame_index} is black"
    rad = rec.renderer.radiance()
    assert np.isfinite(rad).all() and rad.mean() > 0.05, rad.mean()
    print(f"recorder, cornell {cfg.width}x{cfg.height} d{cfg.max_depth} spp "
          f"{cfg.spp}: {n} frames, {1e3 * seconds / n:.1f} ms a recorded "
          f"frame (5 warm-up frames and PNG encode included), last batch "
          f"{rec.last_batch}, PNGs decode to {img.shape}, mean "
          f"{img.mean():.2f} (max {img.max()}), accumulated radiance mean "
          f"{rad.mean():.4f}")


def farm_on_one_card(dev) -> None:
    """A Coordinator and two WorkerClient(device="cuda") threads render
    cornell 720x480 d10 spp 4, 4 frames in jobs of 2; the frames are byte-
    equal to a solo record_chunks. (Two workers share the process-wide
    launch counts, so none are asserted here.)"""
    config = RenderConfig(width=720, height=480, max_depth=10, shader_spp=1,
                          spp=4, fps=4, duration=1.0)
    t0 = time.perf_counter()
    solo = VideoRecorder(_default_renderer_factory(
        config, "cornell", None, b"", device=dev)).record_chunks(config, 0, 4)
    solo_s = time.perf_counter() - t0
    coord = Coordinator(secret="smoke")
    workers = [WorkerClient("127.0.0.1", coord.port, secret="smoke",
                            device=dev) for _ in range(2)]
    errors = []

    def work(w):
        try:
            w.connect()
            w.run()
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    try:
        coord.set_scene(config, "cornell")
        threads = [threading.Thread(target=work, args=(w,), daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        coord.start_render(total_frames=4, job_batch=2)
        assert coord.wait(300.0), (coord.admin_status(), errors)
        farm_s = time.perf_counter() - t0
        frames = coord.collect_frames()
    finally:
        for w in workers:
            w.close()
        coord.close()
    assert not errors, errors
    assert [f.frame_index for f in frames] == [0, 1, 2, 3]
    for f, ref in zip(frames, solo):
        assert f.data == ref.data, f"farm frame {f.frame_index} differs"
    print(f"farm on one card, cornell 720x480 d10 spp 4: 2 workers, 4 frames "
          f"in jobs of 2 in {farm_s:.2f} s (solo {solo_s:.2f} s), byte-equal "
          f"to the solo record_chunks")


def cli_and_preview() -> None:
    """`cli render` (720x480, 16 frames, live preview on) and `cli info` in
    subprocesses, both exit 0 and the PNG decodes; then the preview's
    `publish` of that 720x480 frame, timed."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.png")
        for argv in (["render", "--scene", "cornell", "--width", "720",
                      "--height", "480", "--frames", "16", "--preview", "0",
                      "--output", out], ["info", "--scene", "cornell"]):
            proc = subprocess.run(
                [sys.executable, "-m", "webgpu_raytracer_tpu_torch.cli",
                 *argv], cwd=root, capture_output=True, text=True,
                timeout=300)
            assert proc.returncode == 0, (argv, proc.stdout, proc.stderr)
            lines = proc.stdout.splitlines()
            stats = [x for x in lines if x.startswith("[stats]")][-1:]
            for line in stats + [x for x in lines if x.startswith(
                    ("[render]", "  triangles"))]:
                print(f"cli {argv[0]}: {line.strip()}")
        cli_img = decode_png(open(out, "rb").read())
        assert cli_img.shape == (480, 720, 3) and cli_img.mean() > 10
    srv = PreviewServer(port=0)
    try:
        srv.publish(cli_img)
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            srv.publish(cli_img, stats="smoke")
        ms = 1e3 * (time.perf_counter() - t0) / n
    finally:
        srv.close()
    print(f"preview publish {cli_img.shape[1]}x{cli_img.shape[0]}: {ms:.2f} "
          f"ms (JPEG encode in numpy, mean of {n}; the cli's frame, mean "
          f"{cli_img.mean():.2f})")


def profile_paths(paths) -> None:
    """torch.profiler over 2 frames of each path (`profile_kernels`, which
    fails when it sees fewer device launches than the port counted):
    device time by kernel and the device's busy share of the same 2
    frames' wall time, taken inside the profiled window (the tracer's start
    and stop fall outside it; its cost per launch does not, so the share is
    a floor)."""
    from torch.profiler import ProfilerActivity, profile

    # The first profile of a process also pays the tracer's start-up:
    # spend it on a warm-up, outside the measured windows.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        paths[0][1]()
        torch.cuda.synchronize()
    for label, fn in paths:
        fn()
        torch.cuda.synchronize()
        events, wall_us = profile_kernels(fn, 2)
        busy = sum(t for _, t, _ in events)
        launches = sum(c for _, _, c in events)
        print(f"profile {label}: device busy {busy / 2e3:.3f} ms/frame in "
              f"{launches / 2:.0f} kernel launches/frame, busy share of "
              f"profiled wall {busy / wall_us:.3f} ({wall_us / 2e3:.3f} "
              f"ms/frame profiled)")
        for key, t, count in sorted(events, key=lambda e: -e[1])[:8]:
            print(f"  {t / 2e3:9.3f} ms/frame  {count / 2:7.1f} calls/frame"
                  f"  {key[:70]}")


def sharded_frames(dev, timed, out: dict) -> None:
    """--frame-times' sharded steps: the tile (spp 1) and sample
    (SHARD_SPP) steps of cornell 512^2 d8 on a NCCL world of one, on the
    BVH path and on the dense one, each through `timed` eager and, where
    the checkout's steps are captured (`sharding.ShardedStep`), again as
    "... graph" with the same digest. An older checkout's step is a
    function: its eager arm alone."""
    import torch.distributed as dist

    captured = hasattr(sharding, "ShardedStep")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=torch.device(DEVICE, 0))
    mesh = sharding.make_mesh(DEVICE)
    jit0 = torch.zeros(2, device=dev)
    try:
        for backend in ("bvh", "dense"):
            world = NativeWorld("cornell")
            world.update_camera(*SMALL)
            cam = torch.from_numpy(np.asarray(world.camera(),
                                              np.float32)).to(dev)
            scene = (build_device_scene(world, device=dev)
                     if backend == "bvh"
                     else (build_world_tables(world, dev), None))
            for kind, make, spp in (
                    ("tile", sharding.tile_sharded_step, 1),
                    ("sample", sharding.sample_sharded_step, SHARD_SPP)):
                label = f"sharded {kind} NCCL cornell 512^2 {backend}"
                tags = ("", " graph") if captured else ("",)
                for tag in tags:
                    step = make(mesh, *SMALL, spp, DEPTH, backend=backend)
                    if captured and not tag:
                        step.steps = sharding.EagerSteps()
                    acc = torch.zeros((SMALL[0] * SMALL[1], 4), device=dev)
                    timed(label + tag, lambda f, st=step, a=acc: st(
                        scene, cam, f, jit0, a).clone())
                assert len({out["digest"][label + t] for t in tags}) == 1
    finally:
        dist.destroy_process_group()


def frame_times(dev, smi_line: str, profile: bool = False) -> None:
    """--frame-times: ms/frame (host clock over frames 2..8, ending in a
    synchronise), the kernels' launches a frame and a digest of the frames'
    bits, for cornell 1920x1080 d8 traced, the textured quad 1920x1080 d8
    traced, the formats scene at 1920x1080 d8 through `Renderer`, the
    textured quad's `Renderer` at 512^2 d8 with use_gbuffer=True, cornell's
    `Renderer` at 512^2 d8 (each `Renderer` eager, and again through
    captured steps as "... graph" where the checkout has them, with the
    same digest), the sharded tile and sample steps of cornell 512^2 d8 on
    a NCCL world of one, both backends (`sharded_frames`: eager, and
    "... graph" where the checkout captures them), and cornell's and
    `spheres`' 512^2 d8 BVH frames (`trace_pixels`); one JSON line. It calls only what every version of the port since the
    formats scene has, so one copy of this script, run from the root of two
    checkouts in one call, compares them (parent, change, change, parent):

        cp chip_smoke.py CHECKOUT/chip_smoke_frames.py
        cd CHECKOUT && python3 chip_smoke_frames.py --frame-times

    Then `bvh_shade` alone on cornell's, `spheres`' and mixed's (Lambert,
    metal and glass lanes in a warp) bounces 0 and 4 at 512^2 and
    1920x1080 (`time_bvh_shade`: graph-timed and host-paced ms, the
    wrapper's host us, bound and share), in the JSON line's "bvh_shade",
    and, where the checkout has the ShadePack, the wrapper's host cost
    split into its parts (`bvh_shade_host_split`, three times).
    With --profile it then profiles the two BVH paths (`profile_paths`):
    their device kernels a frame and the device's busy share.
    """
    n = 8
    bvh_paths = []
    jit0 = torch.zeros(2, device=dev)
    out = {"frame_ms": {}, "launches": {}, "mean": {}, "digest": {}}

    def timed(label, fn):
        kernels.reset_launches()
        frames = [fn(1)]
        launches = {k: v for k, v in kernels.launches.items() if v}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(2, n + 1):
            frames.append(fn(f))
        torch.cuda.synchronize()
        out["frame_ms"][label] = 1e3 * (time.perf_counter() - t0) / (n - 1)
        out["launches"][label] = launches
        out["mean"][label] = float(frames[-1].mean())
        digest = hashlib.sha256()
        for x in frames:
            digest.update(x.cpu().numpy().tobytes())
        out["digest"][label] = digest.hexdigest()[:16]

    world = NativeWorld("cornell")
    world.update_camera(*HD)
    tables = build_world_tables(world, dev)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    timed("cornell 1080p traced", lambda f: trace_pixels_dense(
        tables, cam, f, jit0, *HD, 1, DEPTH))
    tq_tables, tq_cam, tq_tex = textured_scene(textured_quad_glb(), *HD, dev)
    timed("textured quad 1080p traced", lambda f: trace_pixels_dense(
        tq_tables, tq_cam, f, jit0, *HD, 1, DEPTH, textures=tq_tex))

    def renderer(r, use_gbuffer=False):
        def frame(_):
            r.render_frame(use_gbuffer=use_gbuffer)
            r.present()
            return r.accum.clone()
        return frame

    try:  # a checkout with the captured frame steps
        from webgpu_raytracer_tpu_torch.render.renderer import (
            CapturedSteps, EagerSteps)
    except ImportError:  # an older one: its Renderer is eager
        CapturedSteps = EagerSteps = None

    def renderers(label, make, use_gbuffer=False):
        """The Renderer's frames eager and, where the checkout has them,
        through captured steps (label + " graph"); the same digest."""
        r = make()
        if EagerSteps is not None:
            r.steps = EagerSteps()
        timed(label, renderer(r, use_gbuffer))
        if CapturedSteps is not None:
            r.steps = CapturedSteps(dev)
            r.reset_accumulation()
            timed(label + " graph", renderer(r, use_gbuffer))
            assert out["digest"][label + " graph"] == out["digest"][label]

    cfg = RenderConfig(width=HD[0], height=HD[1], max_depth=DEPTH)
    renderers("Renderer texture formats 1080p", lambda: Renderer(
        "viewer", config=cfg, glb_data=formats_scene_glb(), device=dev))
    cfg = RenderConfig(width=SMALL[0], height=SMALL[1], max_depth=DEPTH)
    renderers("Renderer textured quad 512^2 G-buffer seeded",
              lambda: Renderer("viewer", config=cfg,
                               glb_data=textured_quad_glb(), device=dev),
              use_gbuffer=True)
    renderers("Renderer cornell 512^2", lambda: Renderer(
        "cornell", config=RenderConfig(width=SMALL[0], height=SMALL[1],
                                       max_depth=DEPTH), device=dev))
    sharded_frames(dev, timed, out)
    for name in ("cornell", "spheres"):
        world = NativeWorld(name)
        world.update_camera(*SMALL)
        scene = build_device_scene(world, device=dev)
        cam = torch.from_numpy(np.asarray(world.camera(),
                                          np.float32)).to(dev)
        label = f"{name} 512^2 BVH"
        timed(label, lambda f: trace_pixels(scene, cam, f, jit0, *SMALL, 1,
                                            DEPTH))
        bvh_paths.append((label, lambda s=scene, c=cam: trace_pixels(
            s, c, 1, jit0, *SMALL, 1, DEPTH)))
    out["bvh_shade"] = {}
    for name in ("cornell", "spheres", "mixed"):
        world = NativeWorld(name)
        scene = build_device_scene(world, device=dev)
        pack, kw = intersect.pack_walk(scene), shade_kw(scene)
        for size in (SMALL, HD):
            world.update_camera(*size)
            cam = torch.from_numpy(np.asarray(world.camera(),
                                              np.float32)).to(dev)
            for depth in (0, 4):
                label = f"{name} {size[0]}x{size[1]} depth {depth}"
                args = bvh_bounce_inputs(scene, cam, *size, depth, pack, kw)
                out["bvh_shade"][label] = time_bvh_shade(label, args, kw)
                if label == "spheres 512x512 depth 0" and kw:
                    out["bvh_shade host us"] = [
                        bvh_shade_host_split(args, kw) for _ in range(3)]
    if profile:
        profile_paths(bvh_paths)
    print(smi_line)
    print(json.dumps(out))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if argv[:1] == ["--shard-rank"]:  # a rank of sharding_on_one_card
        shard_rank(int(argv[1]), int(argv[2]), int(argv[3]), argv[4])
        return 0
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
    if "--frame-times" in argv:
        frame_times(dev, smi_line, "--profile" in argv)
        return 0

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

    # The plain sampler's f64 fused multiply-add against a true f32 one on
    # the formats scene's 1080p primary hits, every layer in turn.
    ro, rd = pinhole_rays(fm_cam, *hd)
    hit = intersect_and_shade(fm_tables, fm_tex, ro, rd)
    lane = torch.arange(hd[0] * hd[1], device=dev, dtype=torch.int32)
    layer = torch.where(hit.wt >= 0, lane % 4, -1)
    for name, level in (("level 0", fm_tex[0]), ("mip", fm_tex[1])):
        bad, total = fma_ties(level, layer, hit.tex_u, hit.tex_v)
        print(f"sampler fused multiply-adds, texture formats 1080p primary "
              f"hits, {name}: the plain version's f64 emulation rounds {bad} "
              f"of {total} otherwise than a true f32 fma (one ulp each)")

    # --- phase 3: every path, counting launches ---
    totals = {k: 0 for k in kernels.launches}
    traced_hd = []
    drive("cornell 512^2 traced", 32, rows_launches(False),
          lambda: frames(tables, camera, width, height, 32, "cornell_512"),
          totals)
    drive("cornell 1080p traced", 8, rows_launches(False),
          lambda: traced_hd.append(frames(tables, cam_hd, *hd, 8,
                                          "cornell_1080p")), totals)

    r = Renderer("cornell", config=RenderConfig(width=width, height=height,
                                         max_depth=DEPTH), device=dev)
    drive("Renderer cornell 512^2", 16, rows_launches(False),
          lambda: renderer_frames(r, 16, f"cornell {width}x{height} "
                                  f"d{DEPTH}", rows_launches(False)),
          totals)

    tq_launches = textured_launches(tq_tables, False)
    assert tq_launches == {
        "dense_sweep": 9, "cluster_cull": 0, "job_sweep": 0,
        "cluster_cull_keyed": 0, "scan_sweep": 0, "shade_rows": 8,
        "fetch_rows": 0, "fetch_quad": 0, "bvh_closest": 0, "bvh_shadow": 0,
        "bvh_shade": 0, "bvh_walk": 0, "all_reduce": 0}
    textured_shades = drive(
        "textured quad 1080p traced", 8, tq_launches,
        lambda: frames(tq_tables, tq_cam, *hd, 8, "textured_1080p",
                       textures=tq_tex), totals)["shade_rows"]
    quad_row, shades, rf = texture_formats(dev, smi_line, totals)
    results.append(quad_row)
    textured_shades += shades

    seeded_hd = []
    drive("cornell 1080p G-buffer seeded", 8, rows_launches(True),
          lambda: seeded_hd.append(frames(tables, cam_hd, *hd, 8,
                                          "cornell_1080p", seeded=True)),
          totals)
    assert torch.equal(seeded_hd[0], traced_hd[0]), \
        "seeded frame 1 differs from the traced frame 1"
    print("cornell 1080p: seeded frame 1 bit-equal to the traced frame 1")

    rt = Renderer("viewer", config=RenderConfig(width=width, height=height,
                                         max_depth=DEPTH),
                  glb_data=glb, device=dev)
    assert rt.textures is not None and rt.textures[1].shape == (1, 128, 128)
    textured_shades += drive(
        "Renderer textured quad 512^2 G-buffer seeded", 8,
        textured_launches(rt.tables, True),
        lambda: renderer_frames(rt, 8, f"textured quad {width}x{height} "
                                f"d{DEPTH} use_gbuffer=True",
                                textured_launches(rt.tables, True),
                                use_gbuffer=True),
        totals)["shade_rows"]
    jobs_sp = []
    drive("spheres 512^2 traced", 4, rows_launches(False, True),
          lambda: jobs_sp.append(frames(sp_tables, sp_cam, width, height, 4,
                                        "spheres_512")), totals)
    rs = Renderer("spheres", config=RenderConfig(width=width, height=height,
                                          max_depth=DEPTH), device=dev)
    drive("Renderer spheres 512^2", 4, rows_launches(False, True),
          lambda: renderer_frames(rs, 4, f"spheres {width}x{height} "
                                  f"d{DEPTH}", rows_launches(False, True)),
          totals)
    scan_launches = rows_launches(False, True, "scan")
    assert scan_launches == {
        "dense_sweep": 0, "cluster_cull": 0, "job_sweep": 0,
        "cluster_cull_keyed": 9, "scan_sweep": 9, "shade_rows": 8,
        "fetch_rows": 0, "fetch_quad": 0, "bvh_closest": 0, "bvh_shadow": 0,
        "bvh_shade": 0, "bvh_walk": 0, "all_reduce": 0}
    scan_sp = []
    drive("spheres 512^2 traced narrow=scan", 4, scan_launches,
          lambda: scan_sp.append(frames(sp_tables, sp_cam, width, height, 4,
                                        "spheres_512", narrow="scan")),
          totals)
    assert bits_equal(scan_sp[0], jobs_sp[0]), \
        "spheres: the scan path's frame 1 differs from the job path's"
    print("spheres 512^2: narrow=scan frame 1 bit-equal to the narrow=jobs "
          "frame 1")
    rsc = Renderer("spheres", config=RenderConfig(width=width, height=height,
                                           max_depth=DEPTH), device=dev,
                   narrow="scan")
    drive("Renderer spheres 512^2 narrow=scan", 4, scan_launches,
          lambda: renderer_frames(rsc, 4, f"spheres {width}x{height} "
                                  f"d{DEPTH} narrow=scan", scan_launches),
          totals)

    # The BVH path (`trace_pixels`), and both tracers through get_tracer.
    drive("cornell 512^2 BVH", 32, bvh_launches(),
          lambda: bvh_frames(bvh_cornell, camera, width, height, 32,
                             "cornell_512"), totals)
    drive("spheres 512^2 BVH", 4, bvh_launches(),
          lambda: bvh_frames(bvh_sp, sp_cam, width, height, 4,
                             "spheres_512"), totals)
    for key in ("cornell_512", "spheres_512"):
        (b_ms, b_mr), (d_ms, d_mr) = FRAME_MS[f"{key} bvh"], FRAME_MS[key]
        print(f"{key} d{DEPTH}, this run: BVH {b_ms:.3f} ms/frame, "
              f"{b_mr:.2f} Mrays/s; dense (narrow=jobs) {d_ms:.3f} "
              f"ms/frame, {d_mr:.2f} Mrays/s")

    def both_tracers():
        jit0 = torch.zeros(2, device=dev)
        cols = {b: get_tracer(b)(scene, camera, 1, jit0, width, height, 1,
                                 DEPTH)
                for b, scene in (("bvh", bvh_cornell),
                                 ("dense", (tables, None)))}
        close = torch.isclose(cols["bvh"], cols["dense"], rtol=1e-3,
                              atol=1e-3).all(1).float().mean()
        print(f"get_tracer cornell 512^2 d{DEPTH}: bvh mean "
              f"{float(cols['bvh'].mean()):.4f}, dense mean "
              f"{float(cols['dense'].mean()):.4f}, {float(close):.4f} of "
              f"the lanes within 1e-3")
        assert close > 0.98, "the two tracers disagree"

    drive("get_tracer bvh + dense, cornell 512^2", 1,
          {**rows_launches(False), "bvh_closest": DEPTH,
           "bvh_shadow": DEPTH, "bvh_walk": 2 * DEPTH, "bvh_shade": DEPTH},
          both_tracers, totals)
    shard_out = sharding_on_one_card(dev, totals, "--profile" in argv)

    # The frame steps eager and captured on every Renderer cell.
    step_cells = [
        ("Renderer cornell 512^2", r, False, 24, rows_launches(False)),
        ("Renderer cornell 1080p", Renderer("cornell", config=RenderConfig(
            width=hd[0], height=hd[1], max_depth=DEPTH), device=dev), False,
         8, rows_launches(False)),
        ("Renderer textured quad 512^2 G-buffer seeded", rt, True, 8,
         textured_launches(rt.tables, True)),
        ("Renderer texture formats 1080p", rf, False, 8,
         textured_launches(rf.tables, False)),
        ("Renderer spheres 512^2", rs, False, 8, rows_launches(False, True)),
        ("Renderer spheres 512^2 narrow=scan", rsc, False, 8, scan_launches),
        ("Renderer cornell 512^2 BVH (render_step backend=\"bvh\")",
         bvh_renderer(dev, width, height), False, 16, bvh_launches())]
    steps_out = compiled_steps(step_cells, totals)
    steps_out["present device ms"] = present_costs(dev)
    steps_out["sharded steps"] = shard_out
    textured_shades += sum(len(STEP_ARMS) * n * pf["shade_rows"]
                           for _, rr, _, n, pf in step_cells
                           if rr.textures is not None)
    print(smi_line)
    print(json.dumps({"compiled steps": steps_out}))

    # --- phase 4: the product surface ---
    animated_tick(dev, totals)
    checkpoint_resume(dev, totals)
    record_defaults(dev, totals)
    farm_on_one_card(dev)
    cli_and_preview()
    print(f"launches on the main paths (all of the above): {totals}")

    if "--profile" in argv:
        from webgpu_raytracer_tpu_torch.render.renderer import (
            CapturedSteps, EagerSteps)

        def renderer_frame(rr, steps, use_gbuffer=False):
            def frame():  # a Renderer frame with these steps (one cache)
                rr.steps = steps
                rr.render_frame(use_gbuffer=use_gbuffer)
                rr.present()
            return frame

        jit0 = torch.zeros(2, device=dev)
        profile_paths([
            ("Renderer cornell 512^2 d8 eager", renderer_frame(
                r, EagerSteps())),
            ("Renderer cornell 512^2 d8 graph", renderer_frame(
                r, CapturedSteps(dev))),
            ("Renderer textured quad 512^2 d8 seeded eager", renderer_frame(
                rt, EagerSteps(), True)),
            ("Renderer textured quad 512^2 d8 seeded graph", renderer_frame(
                rt, CapturedSteps(dev), True)),
            ("Renderer spheres 512^2 d8 eager", renderer_frame(
                rs, EagerSteps())),
            ("Renderer spheres 512^2 d8 graph", renderer_frame(
                rs, CapturedSteps(dev))),
            ("spheres 512^2 d8", lambda: trace_pixels_dense(
                sp_tables, sp_cam, 1, jit0, width, height, 1, DEPTH)),
            ("spheres 512^2 d8 narrow=scan", lambda: trace_pixels_dense(
                sp_tables, sp_cam, 1, jit0, width, height, 1, DEPTH,
                narrow="scan")),
            ("textured quad 1080p d8", lambda: trace_pixels_dense(
                tq_tables, tq_cam, 1, jit0, *hd, 1, DEPTH, textures=tq_tex)),
            ("texture formats 1080p d8", lambda: trace_pixels_dense(
                rf.tables, rf.camera, 1, jit0, *hd, 1, DEPTH,
                textures=rf.textures)),
            ("textured quad 512^2 d8 G-buffer seeded",
             lambda: trace_pixels_dense(
                 rt.tables, rt.camera, 1, jit0, width, height, 1, DEPTH,
                 textures=rt.textures, seed_wt_idx=render_gbuffer(
                     rt.tables, rt.textures, rt.camera, width, height)
                 .wt_idx.reshape(-1))),
            ("cornell 1080p d8 seeded", lambda: trace_pixels_dense(
                tables, cam_hd, 1, jit0, *hd, 1, DEPTH,
                seed_wt_idx=render_gbuffer(tables, None, cam_hd, *hd)
                .wt_idx.reshape(-1))),
            ("cornell 1080p d8 traced", lambda: trace_pixels_dense(
                tables, cam_hd, 1, jit0, *hd, 1, DEPTH)),
            ("cornell 512^2 d8 traced", lambda: trace_pixels_dense(
                tables, camera, 1, jit0, width, height, 1, DEPTH)),
            ("cornell 512^2 d8 BVH", lambda: trace_pixels(
                bvh_cornell, camera, 1, jit0, width, height, 1, DEPTH)),
            ("spheres 512^2 d8 BVH", lambda: trace_pixels(
                bvh_sp, sp_cam, 1, jit0, width, height, 1, DEPTH)),
        ])

    # Every shade of a textured scene ran the textured instantiation.
    shade_tex_row["launches"] = textured_shades
    shade_row["launches"] = totals["shade_rows"] - textured_shades
    for res in results:  # the formats row holds its own scene's count
        if "launches" not in res:
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
