#!/usr/bin/env python3
"""Probe what bounds the PyTorch port's two exact cull kernels
(`webgpu_raytracer_tpu_torch/csrc/cluster_cull.cu`) on the card.

    cd <checkout root> && python3 tools/torch_cull_probe.py

All on the fused bounce-1 sweep of `spheres` 512^2 depth 8 (524,288 lanes,
2,009 clusters: the shapes `chip_smoke.py` times), device ms per call over
100 launches between one pair of CUDA events after 3 warm-ups. It prints
the card's name and power limit first, then:

- the SM clock and the power draw while the unkeyed cull runs in a loop
  (`nvidia-smi` sampled every 250 ms beside it);
- both kernels with other block layouts than the source's constants: it
  builds `cluster_cull.cu` alone with `-DWRT_CULL_WARPS=` 2 and 4 (the
  unkeyed cull beside the library's 8 warps a block) and with
  `-DWRT_KEYED_SLICE_BLOCKS=` 2, 3, 4 and 8 (the keyed cull beside the
  library's 6 32-cluster blocks a grid slice), and with
  `-DWRT_CULL_MIN_BLOCKS=` and `-DWRT_KEYED_MIN_BLOCKS=` 0 to 3 (the
  blocks an SM that the launch bounds of the kernels at four lanes a
  thread ask for: 0 leaves the registers to ptxas, 1 to 3 cap them at 255,
  128 and 85; ptxas' registers and spills are printed beside both kernels'
  times); every result is held equal to the wrappers';
- a stack whose lanes are all dead (what the launch costs when every block
  leaves at once), and the unkeyed cull over the first n live groups only,
  n from half an SM count to all of them: the time of one block alone on an
  SM, and where more blocks an SM stop adding throughput;
- the card's instruction rate for separately rounded f32 operations, from a
  kernel of eight independent chains a thread (`__fmul_rn` then
  `__fadd_rn`, the second operand a kernel argument or a register of its
  own) beside the same chains as fused multiply-adds, at 8 to 64 warps an
  SM, in warp instructions per clock and SM at the clock read above. The
  culls' arithmetic is of the first kind.

The last line is one JSON object of everything measured.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from webgpu_raytracer_tpu_torch import NativeWorld, kernels  # noqa: E402
from webgpu_raytracer_tpu_torch.ops import cuda_jobs, cuda_scan  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (  # noqa: E402
    A_LO_SCALE, HI_NUDGE)
from webgpu_raytracer_tpu_torch.ops.coherence import (  # noqa: E402
    coherence_sort)
from webgpu_raytracer_tpu_torch.ops.dense import T_MIN  # noqa: E402
from webgpu_raytracer_tpu_torch.ops.dense_trace import (  # noqa: E402
    bounce_rays)
from webgpu_raytracer_tpu_torch.ops.tune import M_TILE2, M_TILE3  # noqa: E402
from webgpu_raytracer_tpu_torch.render.worldtris import (  # noqa: E402
    build_world_tables)

W = H = 512
DEPTH = 8
LAUNCHES = 100
SM_COUNT = 132

FP_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdio>
template <int MODE>
__global__ void chains(float* out, float c, float d, int n) {
  float a[8], b[8], e[8];
  for (int i = 0; i < 8; ++i) {
    a[i] = threadIdx.x * 0.001f + i;
    b[i] = 1.f + c * (i + threadIdx.x);
    e[i] = d * (i + 1 + threadIdx.x);
  }
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (MODE == 0) { a[i] = __fmul_rn(a[i], c); a[i] = __fadd_rn(a[i], d); }
      if (MODE == 1) {
        a[i] = __fmul_rn(a[i], b[i]);
        a[i] = __fadd_rn(a[i], e[i]);
      }
      if (MODE == 2) {
        a[i] = __fmaf_rn(a[i], c, d);
        a[i] = __fmaf_rn(a[i], c, d);
      }
    }
  }
  float s = 0;
  for (int i = 0; i < 8; ++i) s += a[i] + b[i] + e[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int MODE>
void run(const char* name, float* out, int warps_per_sm, double hz) {
  const int n = 8192, threads = 256, blocks = 132 * warps_per_sm / 8;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  chains<MODE><<<blocks, threads>>>(out, 1.0001f, 0.0001f, n);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  chains<MODE><<<blocks, threads>>>(out, 1.0001f, 0.0001f, n);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double instr = (double)blocks * (threads / 32) * n * 16.0;
  printf("%s %d %.4f\n", name, warps_per_sm, instr / (ms * 1e-3 * hz * 132));
}
int main(int argc, char** argv) {
  const double hz = atof(argv[1]);
  float* out;
  cudaMalloc(&out, 132 * 64 * 256 * 4);
  for (int w : {8, 16, 32, 64}) {
    run<0>("fmul_fadd_argument", out, w, hz);
    run<1>("fmul_fadd_registers", out, w, hz);
    run<2>("ffma", out, w, hz);
  }
  return 0;
}
"""


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


def cull_variants(tmp: str, main: ctypes.CDLL) -> dict:
    """`cluster_cull.cu` alone, one shared library per block layout (all
    nvcc processes started together): {(macro, value): library}, the
    loaded library `main` standing for the source's own constants."""
    src = os.path.join(kernels.CSRC_DIR, "cluster_cull.cu")
    settings = [("WRT_CULL_WARPS", v) for v in (2, 4)] + \
        [("WRT_KEYED_SLICE_BLOCKS", v) for v in (2, 3, 4, 8)] + \
        [("MIN_BLOCKS", v) for v in (0, 1, 2, 3)]
    jobs = []
    for macro, value in settings:
        so = os.path.join(tmp, f"cull_{macro}_{value}.so")
        defines = [f"-D{macro}={value}"]
        if macro == "MIN_BLOCKS":  # both kernels' at once
            defines = [f"-DWRT_CULL_MIN_BLOCKS={value}",
                       f"-DWRT_KEYED_MIN_BLOCKS={value}"]
        jobs.append((macro, value, so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines,
             "-Xptxas", "-v", "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {("WRT_CULL_WARPS", 8): main, ("WRT_KEYED_SLICE_BLOCKS", 6): main}
    for macro, value, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        lib = ctypes.CDLL(so)
        for name in ("wrt_cluster_cull", "wrt_cluster_cull_keyed"):
            getattr(lib, name).restype = getattr(main, name).restype
            getattr(lib, name).argtypes = getattr(main, name).argtypes
        libs[(macro, value)] = lib
        if macro == "MIN_BLOCKS":
            libs[(macro, value, "ptxas")] = four_lane_registers(log)
    return libs


def four_lane_registers(log: str) -> dict:
    """From nvcc's `-Xptxas -v` output: {kernel: "N registers, ... spill"}
    of the two kernels' four-lanes-a-thread instantiations."""
    found, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = ("cull_keyed" if "keyed_kernelILi4E" in line else
                    "cull" if "cull_kernelILi4E" in line else None)
        elif name and "spill" in line:
            found[name] = line.split(",", 1)[1].strip()
        elif name and "Used" in line:
            found[name] = (line.split("Used", 1)[1].split(",")[0].strip()
                           + ", " + found.get(name, ""))
    return found


def fp_instruction_rates(mhz: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "fp.cu"), os.path.join(tmp, "fp")
        with open(src, "w") as f:
            f.write(FP_SOURCE)
        subprocess.run([kernels._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o", exe,
                        src], check=True)
        out = subprocess.run([exe, str(mhz * 1e6)], check=True,
                             capture_output=True, text=True).stdout
    rates: dict = {}
    for line in out.splitlines():
        name, warps, rate = line.split()
        rates.setdefault(name, {})[int(warps)] = float(rate)
    return rates


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    lib = kernels.library()
    world = NativeWorld("spheres")
    world.update_camera(W, H)
    tables = build_world_tables(world, "cuda")
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
    R = W * H
    rays8 = bounce_rays(tables, camera, W, H, 1, DEPTH)
    sp, box = tables.spheres, tables.box
    ct = sp.shape[0]
    stream = kernels.stream(sp.device)
    g, m = M_TILE3, M_TILE2
    rays_j, _ = coherence_sort(rays8, box, g, R)
    rays_s, _ = coherence_sort(rays8, box, m, R)
    order_w, counts_w = cuda_jobs.worklists(sp, rays_j, g, box)
    keys_w = cuda_scan.cluster_keys(sp, rays_s, m, box)
    pos = torch.arange(ct, device="cuda")[None, :] < counts_w[:, None]

    def unkeyed(stack, lib=lib):
        G = stack.shape[1] // g
        order = torch.empty((G, ct), dtype=torch.int32, device="cuda")
        counts = torch.empty(G, dtype=torch.int32, device="cuda")

        def launch():
            code = lib.wrt_cluster_cull(
                sp.data_ptr(), ct, stack.data_ptr(), stack.shape[1], g,
                box.data_ptr(), A_LO_SCALE, HI_NUDGE, order.data_ptr(),
                counts.data_ptr(), stream)
            assert code == 0, code
        return launch, order, counts

    def keyed(stack, lib=lib):
        keys = torch.empty((stack.shape[1] // m, ct), dtype=torch.float32,
                           device="cuda")

        def launch():
            code = lib.wrt_cluster_cull_keyed(
                sp.data_ptr(), ct, stack.data_ptr(), stack.shape[1], m,
                box.data_ptr(), T_MIN, keys.data_ptr(), stream)
            assert code == 0, code
        return launch, keys

    out: dict = {"checkout": os.getcwd()}
    mhz, watts = clock_under(lambda: cuda_jobs.worklists(sp, rays_j, g, box))
    out["sm_mhz_under_cull"], out["watts_under_cull"] = mhz, watts
    print(f"under the unkeyed cull: {mhz:.0f} MHz, {watts:.1f} W")

    out["cull_ms_by_warps"] = {}
    out["cull_keyed_ms_by_slice_blocks"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        variants = cull_variants(tmp, lib)
        for warps in (2, 4, 8):
            launch, order, counts = unkeyed(
                rays_j, variants["WRT_CULL_WARPS", warps])
            out["cull_ms_by_warps"][warps] = device_ms(launch)
            assert torch.equal(counts, counts_w) and torch.equal(
                torch.where(pos, order, -1), torch.where(pos, order_w, -1))
        for blocks in (2, 3, 4, 6, 8):
            launch, keys = keyed(
                rays_s, variants["WRT_KEYED_SLICE_BLOCKS", blocks])
            out["cull_keyed_ms_by_slice_blocks"][blocks] = device_ms(launch)
            assert torch.equal(keys.view(torch.int32),
                               keys_w.view(torch.int32))
        out["by_min_blocks"] = {}
        for n in (0, 1, 2, 3):
            lib_n = variants["MIN_BLOCKS", n]
            launch, order, counts = unkeyed(rays_j, lib_n)
            launch_k, keys = keyed(rays_s, lib_n)
            out["by_min_blocks"][n] = {
                "cull_ms": device_ms(launch),
                "cull_keyed_ms": device_ms(launch_k),
                "ptxas": variants["MIN_BLOCKS", n, "ptxas"]}
            assert torch.equal(counts, counts_w) and torch.equal(
                torch.where(pos, order, -1), torch.where(pos, order_w, -1))
            assert torch.equal(keys.view(torch.int32),
                               keys_w.view(torch.int32))
    print("unkeyed cull, ms by least warps a block:", out["cull_ms_by_warps"])
    print("keyed cull, ms by 32-cluster blocks a grid slice:",
          out["cull_keyed_ms_by_slice_blocks"])
    print("both culls by the launch bounds' blocks an SM (four lanes a "
          "thread):", out["by_min_blocks"])

    for name, stack, fn in (
            ("cull", rays_j, lambda s: unkeyed(s)[0]),
            ("cull_keyed", rays_s, lambda s: keyed(s)[0])):
        dead = stack.clone()
        dead[6] = 0.0
        out[f"{name}_all_dead_ms"] = device_ms(fn(dead))
    alive = (rays_j[6].view(-1, g) > 0).any(1)
    live_only = rays_j.view(8, -1, g)[:, alive]
    n_live = int(alive.sum())
    out["cull_ms_by_live_groups"] = {}
    for n in sorted({SM_COUNT // 2, SM_COUNT, 2 * SM_COUNT, 3 * SM_COUNT,
                     4 * SM_COUNT, 5 * SM_COUNT, 6 * SM_COUNT, 7 * SM_COUNT,
                     n_live}):
        if n <= n_live:
            stack = live_only[:, :n].reshape(8, -1).contiguous()
            out["cull_ms_by_live_groups"][n] = device_ms(unkeyed(stack)[0])
    print(f"all-dead stacks: unkeyed {out['cull_all_dead_ms']:.4f} ms, "
          f"keyed {out['cull_keyed_all_dead_ms']:.4f} ms")
    print("unkeyed cull, ms by live groups (no dead ones):",
          out["cull_ms_by_live_groups"])

    out["warp_instructions_per_clock_per_sm"] = fp_instruction_rates(mhz)
    print(f"warp instructions per clock and SM at {mhz:.0f} MHz, by warps "
          f"an SM:", out["warp_instructions_per_clock_per_sm"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
