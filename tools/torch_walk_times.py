#!/usr/bin/env python3
"""Time the PyTorch port's BVH walk kernel
(`webgpu_raytracer_tpu_torch/csrc/bvh_walk.cu`), its quad fetch
(`csrc/fetch_rows.cu::wrt_fetch_quad`) and the BVH frames, for the
checkout in the current directory.

    cd <checkout root> && python3 <this file>

It imports `webgpu_raytracer_tpu_torch` and `chip_smoke` from the current
directory, so one copy of this script can time two checkouts one after the
other on one card (parent, change, change, parent), which is how two
versions of a kernel are compared. It uses only calls that every version
since the walk kernel's first has: `intersect.walk_cuda`,
`intersect.traverse_plain`, `cuda_fetch.fetch_quad`, `trace_pixels` and
`chip_smoke.bvh_rays`; where the checkout has `intersect.pack_walk`, the
scene's pack is built once and handed to every walk, as `trace_pixels`
does, and its build time is reported.

Measured:
- the walk on cornell's and `spheres`' 512^2 stacks: the primaries
  (closest), the bounce-1 extension rays (closest, 22% of the lanes live
  on `spheres`) and the bounce-1 shadow rays (any-hit): device ms per call,
  100 launches between one pair of CUDA events after 3 warm-ups, beside a
  digest of the results and per-lane counts (which two versions must share;
  `warp_node_share` is the share of a warp's node steps its lanes use when
  each warp walks 32 consecutive rays to the longest one's end) and, once a
  run, bit equality with the plain walk on the primaries;
- the quad fetch of the textured quad at 1920x1080 (the mip's 16,384 rows
  and level 0's 1,048,576), bit-equal to its plain version, timed over
  1,000 launches (a window of ~20 ms);
- frames 2..5 of `trace_pixels` (d8, spp 1) on both scenes at 512^2: wall
  ms per frame ending in a synchronise, and the mean radiance.
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

import chip_smoke  # noqa: E402
from webgpu_raytracer_tpu_torch import NativeWorld  # noqa: E402
from webgpu_raytracer_tpu_torch.ops import cuda_fetch, intersect  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.dense_trace import (  # noqa: E402
    intersect_and_shade, pinhole_rays, texel_rows)
from webgpu_raytracer_tpu_torch.ops.fetch import (  # noqa: E402
    device_pyramid, fetch_quad_plain)
from webgpu_raytracer_tpu_torch.ops.trace import trace_pixels  # noqa: E402
from webgpu_raytracer_tpu_torch.render.resources import (  # noqa: E402
    build_device_scene)
from webgpu_raytracer_tpu_torch.render.worldtris import (  # noqa: E402
    SHADE_COLS, build_world_tables)
from webgpu_raytracer_tpu_torch.utils.textures import (  # noqa: E402
    build_quad_pyramid, decode_world_textures)

DEPTH = 8
LAUNCHES = 100
QUAD_LAUNCHES = 1000  # a ~0.02 ms kernel: a window of ~20 ms
FRAMES = 5
SMALL = (512, 512)
HD = (1920, 1080)
HAS_PACK = hasattr(intersect, "pack_walk")

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


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def digest(out, st, any_hit: bool) -> dict:
    """What two versions of the walk must agree on, in a few integers."""
    warps = st.nodes.long().reshape(-1, 32)  # one thread a ray
    d = {"nodes": int(st.nodes.long().sum()),
         "tris": int(st.tris.long().sum()), "max_nodes": int(st.nodes.max()),
         "warp_node_share": float(warps.sum() / (32 * warps.amax(1).sum()))}
    if any_hit:
        d["occluded"] = int(out.sum())
    else:
        d["hits"] = int((out.inst_idx >= 0).sum())
        d["tri_sum"] = int(out.tri_idx.long().sum())
        d["t_bits_sum"] = int(bits(out.t).long().sum())
    return d


def scene_stacks(name: str):
    """(DeviceScene, camera, {stack: (ro, rd, t_max, active,
    any_hit)}) at 512^2."""
    world = NativeWorld(name)
    world.update_camera(*SMALL)
    tables = build_world_tables(world, "cuda")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
    scene = build_device_scene(world, device="cuda")
    (p_ro, p_rd), shadow, ext = chip_smoke.bvh_rays(cam, *SMALL, tables)
    on = torch.ones(p_ro.shape[0], dtype=torch.bool, device="cuda")
    stacks = {"primaries": (p_ro, p_rd, intersect.T_MAX, on, False),
              "extension": (*ext, False), "shadow": (*shadow, True)}
    return scene, cam, stacks


def walk(scene, pack, stack, with_stats=False):
    ro, rd, t_max, active, any_hit = stack
    kw = {"pack": pack} if pack is not None else {}
    return intersect.walk_cuda(scene, ro, rd, intersect.T_MIN, t_max, active,
                               any_hit, with_stats, **kw)


def time_walks(name: str, out: dict) -> tuple:
    """The walk on `name`'s stacks, into `out`: (DeviceScene, camera)."""
    scene, cam, stacks = scene_stacks(name)
    pack = None
    if HAS_PACK:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack = intersect.pack_walk(scene)
        torch.cuda.synchronize()
        out[f"{name}_pack_ms"] = 1e3 * (time.perf_counter() - t0)
    ro, rd, t_max, active, any_hit = stacks["primaries"]
    got, st = walk(scene, pack, stacks["primaries"], True)
    plain, pst = intersect.traverse_plain(scene, ro, rd, intersect.T_MIN,
                                          t_max, active, False)
    for a, b in zip((*got, *st), (*plain, *pst)):
        assert torch.equal(bits(a), bits(b)), f"{name}: kernel != plain"
    for label, stack in stacks.items():
        res, st = walk(scene, pack, stack, True)
        key = f"{name}_{label}"
        out[key] = {"ms": device_ms(lambda: walk(scene, pack, stack)),
                    "lanes": int(stack[0].shape[0]),
                    "live": int(stack[3].sum()),
                    **digest(res, st, stack[4])}
        print(key, out[key])
    return scene, cam


def frame_ms(scene, cam) -> tuple[float, float]:
    jitter = torch.zeros(2, device="cuda")
    means = []

    def frame(f):
        means.append(trace_pixels(scene, cam, f, jitter, *SMALL, 1,
                                  DEPTH).mean())

    frame(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(2, FRAMES + 1):
        frame(f)
    torch.cuda.synchronize()
    return (1e3 * (time.perf_counter() - t0) / (FRAMES - 1),
            float(torch.stack(means).mean()))


def time_quad(out: dict) -> None:
    """The quad fetch on the textured quad's 1080p bounce rows, as
    chip_smoke.py checks it."""
    world = NativeWorld("viewer", glb_data=chip_smoke.textured_quad_glb())
    world.update_camera(*HD)
    tables = build_world_tables(world, "cuda")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
    tex = device_pyramid(build_quad_pyramid(decode_world_textures(world)),
                         "cuda")
    ro, rd = pinhole_rays(cam, *HD)
    hit = intersect_and_shade(tables, tex, ro, rd)
    base = torch.where(hit.wt >= 0,
                       hit.rowT[SHADE_COLS["tex"][0]].to(torch.int32), -1)
    for label, level in (("mip", 1), ("level0", 0)):
        flat = tex[level].flat
        rows = texel_rows(tex[level], base, hit.tex_u, hit.tex_v)[0]
        got = cuda_fetch.fetch_quad(flat, rows)
        assert torch.equal(got, fetch_quad_plain(flat, rows)), label
        out[f"quad_{label}"] = {
            "ms": device_ms(lambda: cuda_fetch.fetch_quad(flat, rows),
                            QUAD_LAUNCHES),
            "rows": int(rows.shape[0]), "table_rows": int(flat.shape[0]),
            "digest": int(got.long().sum())}
        print(f"quad_{label}", out[f"quad_{label}"])


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    out: dict = {"checkout": os.getcwd(), "pack": HAS_PACK}
    for name in ("cornell", "spheres"):
        scene, cam = time_walks(name, out)
        ms, mean = frame_ms(scene, cam)
        out[f"{name}_frame_ms"], out[f"{name}_mean"] = ms, mean
        print(f"{name} BVH frame 512^2 d{DEPTH}: {ms:.3f} ms, mean {mean:.6f}")
    time_quad(out)
    print(json.dumps(out))
    return 0

if __name__ == "__main__":
    sys.exit(main())
