#!/usr/bin/env python3
"""Time the PyTorch port's single-tile sweep kernel
(`webgpu_raytracer_tpu_torch/csrc/dense_sweep.cu`) and the cornell frames
that run on it, for the checkout in the current directory.

    cd <checkout root> && python3 <this file> [--variants [--sass=FILE]]

It imports `webgpu_raytracer_tpu_torch` (and `chip_smoke.sweep_inputs`)
from the current directory, so one copy of this script can time two
checkouts one after the other on one card (parent, change, change,
parent), which is how two versions of the kernel are compared. It uses
only calls that every version since the first has: `cuda_dense.
closest_with_row`, `cuda_dense.shadow`, `bounce_rays`, `trace_pixels_dense`
and the plain versions.

Measured on cornell (36 triangles, one tile), depth 8:
- the sweep of three fused (8, 2R) stacks: `chip_smoke.py`'s synthetic
  one at 512^2 and the real bounce-1 stacks at 512^2 and 1920x1080. Each
  is first held bit-equal to the plain versions (t bits, idx, the rows of
  lanes R.., occlusion), then timed closest + rows (rows of lanes R.., as
  the bounce loop asks), closest without rows (rows from lane 2R) and
  any-hit: device ms per call, 100 launches between one pair of CUDA
  events after 3 warm-ups;
- frames 2..9 of `trace_pixels_dense` at 512^2 and 1920x1080: wall ms per
  frame ending in a synchronise, the host's ms per frame before that
  synchronise (near the wall when the frame is host-bound), and the mean
  radiance (two versions must agree on it);
- the host's microseconds per sweep call, on a 256-lane stack.
Prints the card's name and power limit first, then one JSON line.

With --variants it also probes what bounds the kernel (it needs the
kernel's C entry point only, which every version has): it builds
`dense_sweep.cu` alone with other block shapes than the source's
(-DWRT_SWEEP_THREADS=, -DWRT_SWEEP_RAYS=, -DWRT_SWEEP_MIN_BLOCKS=), prints
ptxas' registers and spills and times each on the synthetic 512^2 stack
(every result held bit-equal to the library's); reads the SM clock and
power under the kernel; times the closest sweep of mixed's first 32, 64
and 128 triangles (the slope is the cost of a (ray, triangle) pair, given
also in issue slots at that clock); and counts the kernel's SASS
instructions by opcode (`cuobjdump -sass`; --sass=FILE writes the whole
listing there).
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import sweep_inputs  # noqa: E402
from webgpu_raytracer_tpu_torch import NativeWorld, kernels  # noqa: E402
from webgpu_raytracer_tpu_torch.ops import cuda_dense  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.dense import (  # noqa: E402
    T_MIN, closest_plain, rows_plain, shadow_plain)
from webgpu_raytracer_tpu_torch.ops.dense_trace import (  # noqa: E402
    bounce_rays, trace_pixels_dense)
from webgpu_raytracer_tpu_torch.render.worldtris import (  # noqa: E402
    build_world_tables)

DEPTH = 8
LAUNCHES = 100
FRAMES = 9
SMALL = (512, 512)
HD = (1920, 1080)
SM_COUNT = 132
# Other values of the source's constants (threads a block, rays a thread,
# launch bounds' blocks an SM); the source's own are timed through the
# library.
VARIANTS = [dict(THREADS=256, RAYS=1, MIN_BLOCKS=4),
            dict(THREADS=256, RAYS=2, MIN_BLOCKS=3),
            dict(THREADS=128, RAYS=4, MIN_BLOCKS=4),
            dict(THREADS=512, RAYS=2, MIN_BLOCKS=1),
            dict(MIN_BLOCKS=0), dict(RAYS=3)]


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


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def check_and_time(tables, rays8, R: int, label: str) -> dict:
    """The kernel bit-equal to the plain versions on one stack, then its
    three timings."""
    t, idx, rows = cuda_dense.closest_with_row(tables, rays8, R)
    occ = cuda_dense.shadow(tables, rays8)
    t_p, i_p = closest_plain(tables, rays8)
    assert torch.equal(bits(t), bits(t_p)) and torch.equal(idx, i_p), label
    assert torch.equal(bits(rows), bits(rows_plain(tables.shade_table,
                                                   i_p[R:]))), label
    assert torch.equal(occ, shadow_plain(tables, rays8)), label
    return {"lanes": 2 * R, "live": int((rays8[6] > 0).sum()),
            "hits": int((idx >= 0).sum()),
            "rows_ms": device_ms(
                lambda: cuda_dense.closest_with_row(tables, rays8, R)),
            "no_rows_ms": device_ms(
                lambda: cuda_dense.closest_with_row(tables, rays8, 2 * R)),
            "any_hit_ms": device_ms(lambda: cuda_dense.shadow(tables, rays8))}


def frame_ms(tables, camera, width, height) -> tuple[float, float, float]:
    """(wall ms a frame, the host's ms a frame before the closing
    synchronise, mean radiance) over frames 2..FRAMES."""
    jitter = torch.zeros(2, device=tables.device)
    means = []

    def frame(f):
        means.append(trace_pixels_dense(tables, camera, f, jitter, width,
                                        height, 1, DEPTH).mean())

    frame(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(2, FRAMES + 1):
        frame(f)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (1e3 * (t2 - t0) / (FRAMES - 1), 1e3 * (t1 - t0) / (FRAMES - 1),
            float(torch.stack(means).mean()))


def host_us_per_sweep(tables, rays8) -> float:
    """Host microseconds a closest_with_row call takes on a 256-lane stack
    (the card's part is negligible): 2,000 calls, then one synchronise."""
    small = rays8[:, :256].contiguous()
    for _ in range(10):
        cuda_dense.closest_with_row(tables, small, 128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        cuda_dense.closest_with_row(tables, small, 128)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / 2000


def raw_launch(lib, tables, rays8, any_hit: bool, row_from: int):
    """A launch of `lib`'s wrt_dense_sweep (the wrapper's arguments) and
    its outputs."""
    R2 = rays8.shape[1]
    dev = rays8.device
    t = torch.empty(R2, dtype=torch.float32, device=dev)
    idx = torch.empty(R2, dtype=torch.int32, device=dev)
    rows = torch.empty((40, R2 - row_from), dtype=torch.float32, device=dev)
    occ = torch.empty(R2, dtype=torch.bool, device=dev)
    tw = tables.features.shape[1] // 5

    def launch():
        code = lib.wrt_dense_sweep(
            tables.features.data_ptr(), tw, tables.valid_count,
            tables.shade_table.data_ptr(), rays8.data_ptr(), R2, T_MIN,
            int(any_hit), row_from, t.data_ptr(), idx.data_ptr(),
            rows.data_ptr() if rows.numel() else None, occ.data_ptr(),
            kernels.stream(dev))
        assert code == 0, code
    return launch, (occ if any_hit else (t, idx, rows))


def build_variants(tmp: str) -> dict:
    """dense_sweep.cu alone, one shared library per variant (all nvcc
    processes started together): {variant: (library, ptxas lines)}."""
    src = os.path.join(kernels.CSRC_DIR, "dense_sweep.cu")
    jobs = []
    for var in VARIANTS:
        key = " ".join(f"{k}={v}" for k, v in var.items())
        so = os.path.join(tmp, f"sweep_{len(jobs)}.so")
        jobs.append((key, so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS,
             *(f"-DWRT_SWEEP_{k}={v}" for k, v in var.items()),
             "-Xptxas", "-v", "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for key, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        lib = ctypes.CDLL(so)
        lib.wrt_dense_sweep.restype = kernels.library().wrt_dense_sweep.restype
        lib.wrt_dense_sweep.argtypes = \
            kernels.library().wrt_dense_sweep.argtypes
        out[key] = (lib, ptxas_lines(log))
    return out


def ptxas_lines(log: str) -> dict:
    """{kernel: "registers, spill"} from nvcc's -Xptxas -v output, for the
    sweep's two instantiations (any-hit true / false)."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = ("any_hit" if "ILb1E" in m.group(1) else "closest"
                    if "ILb0E" in m.group(1) else None)
        elif name and ("Used" in line or "spill" in line):
            found[name] = (found.get(name, "") + " " + line.strip()).strip()
    return found


def sass_counts(path: str, dump: str | None = None) -> dict:
    """{kernel: {opcode: count}} of the sweep's two instantiations in a
    shared library, from cuobjdump -sass; `dump` names a file to write the
    whole listing to."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    if dump:
        os.makedirs(os.path.dirname(os.path.abspath(dump)), exist_ok=True)
        with open(dump, "w") as f:
            f.write(text)
    counts: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            cur = None
            if "dense_sweep_kernel" in fn:
                cur = counts.setdefault(
                    "any_hit" if "ILb1E" in fn else "closest",
                    collections.Counter())
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            line)
        if cur is not None and m:
            cur[m.group(1).split(".")[0]] += 1
    return {k: dict(v.most_common()) for k, v in counts.items()}


def clock_under(fn, seconds: float = 3.0) -> tuple[float, float]:
    """(median SM MHz, median W) sampled while fn runs in a loop."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "250"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [r.split(",") for r in smi.communicate()[0].strip().splitlines()]
    rows = rows[len(rows) // 3:]  # past the ramp
    return (float(np.median([float(r[0]) for r in rows])),
            float(np.median([float(r[1]) for r in rows])))


def probe(tables, rays8, R: int, sass_dump: str | None) -> dict:
    out: dict = {}
    lib = kernels.library()
    mhz, watts = clock_under(
        lambda: cuda_dense.closest_with_row(tables, rays8, R))
    out["sm_mhz"], out["watts"] = mhz, watts
    print(f"under the sweep: {mhz:.0f} MHz, {watts:.1f} W")
    want_c = cuda_dense.closest_with_row(tables, rays8, R)
    want_a = cuda_dense.shadow(tables, rays8)
    out["variants"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, (vlib, ptx) in build_variants(tmp).items():
            res = {"ptxas": ptx}
            for name, any_hit, row_from in (("rows_ms", False, R),
                                            ("no_rows_ms", False, 2 * R),
                                            ("any_hit_ms", True, 0)):
                launch, got = raw_launch(vlib, tables, rays8, any_hit,
                                         row_from)
                launch()
                torch.cuda.synchronize()
                if any_hit:
                    assert torch.equal(got, want_a), key
                else:
                    assert torch.equal(bits(got[0]), bits(want_c[0])), key
                    assert torch.equal(got[1], want_c[1]), key
                    if row_from == R:
                        assert torch.equal(bits(got[2]), bits(want_c[2]))
                res[name] = device_ms(launch)
            out["variants"][key] = res
            print(f"variant {key}: {res}")
    # The cost of a pair: mixed's first n triangles as one tile.
    world = NativeWorld("mixed")
    mixed = build_world_tables(world, "cuda")
    tw = mixed.shade_table.shape[0]
    by_n = {}
    for n in (32, 64, 128):
        cut = mixed._replace(
            features=mixed.features.view(-1, 5, tw)[:, :, :n]
            .reshape(-1, 5 * n).contiguous(),
            shade_table=mixed.shade_table[:n].contiguous(), valid_count=n)
        by_n[n] = device_ms(
            lambda: cuda_dense.closest_with_row(cut, rays8, 2 * R))
    live = int((rays8[6] > 0).sum())
    slope_ms = (by_n[128] - by_n[32]) / 96
    out["closest_no_rows_ms_by_tris"] = by_n
    out["ns_per_live_pair"] = 1e6 * slope_ms / live
    # issue slots (thread instructions) a pair if the card issued one warp
    # instruction a clock on each of its 4 x 132 schedulers
    out["issue_slots_per_pair_at_clock"] = (
        slope_ms * 1e-3 / live * 4 * SM_COUNT * mhz * 1e6 * 32)
    print(f"closest without rows over mixed's first n triangles {by_n} ms: "
          f"{out['ns_per_live_pair']:.6f} ns a live pair, "
          f"{out['issue_slots_per_pair_at_clock']:.1f} issue slots a pair "
          f"at {mhz:.0f} MHz")
    out["sass"] = sass_counts(kernels.build()[0], sass_dump)
    print("SASS instructions by opcode:", out["sass"])
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    world = NativeWorld("cornell")
    out: dict = {"checkout": os.getcwd()}
    stacks = {}
    for (w, h) in (SMALL, HD):
        world.update_camera(w, h)
        tables = build_world_tables(world, "cuda")
        cam = torch.from_numpy(np.asarray(world.camera(),
                                          np.float32)).cuda()
        key = f"{w}x{h}"
        if (w, h) == SMALL:
            stacks["synthetic_" + key] = (tables, torch.from_numpy(
                sweep_inputs(cam, w, h)).cuda(), w * h)
        stacks["bounce1_" + key] = (tables, bounce_rays(
            tables, cam, w, h, 1, DEPTH), w * h)
        for label, (tb, rays8, R) in list(stacks.items()):
            if label.endswith(key) and label not in out:
                out[label] = check_and_time(tb, rays8, R, label)
                print(label, out[label])
        ms, host_ms, mean = frame_ms(tables, cam, w, h)
        out[f"frame_{key}_ms"], out[f"mean_{key}"] = ms, mean
        out[f"frame_{key}_host_ms"] = host_ms
        print(f"frame {key} d{DEPTH}: {ms:.3f} ms ({host_ms:.3f} ms on the "
              f"host before the synchronise), mean {mean:.6f}")
    tables, rays8, _ = stacks["synthetic_512x512"]
    out["host_us_per_sweep"] = host_us_per_sweep(tables, rays8)
    print(f"host cost of a sweep call: {out['host_us_per_sweep']:.2f} us")
    if "--variants" in argv:
        tables, rays8, R = stacks["synthetic_512x512"]
        dump = next((a.split("=", 1)[1] for a in argv
                     if a.startswith("--sass=")), None)
        out["probe"] = probe(tables, rays8, R, dump)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
