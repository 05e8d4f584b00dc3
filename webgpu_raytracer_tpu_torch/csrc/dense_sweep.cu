// Dense rays x world-triangles sweep: closest hit with the winner's shade
// row, or any-hit occlusion.
//
// Replaces webgpu_raytracer_tpu/ops/pallas_dense.py::_kernel (launched by
// _run). It computes what that kernel computes, not its blocking: the TPU
// kernel evaluates the side tests as one bf16x3 MXU matmul per (2048-ray,
// triangle-tile) block and fetches winner rows with a one-hot matmul; here
// one thread owns one ray and walks the triangles in f32.
//
// Layout (the JAX package's public layouts):
//   rays8    (8, n) f32  [dx, dy, dz, ox, oy, oz, t_max, pad]; t_max <= 0
//                        marks an inactive lane
//   features (16, 5*tw) f32, column groups [s0 | s1 | s2 | tn | td]
//   shade    (tw, 40) f32 shade rows
//   out_t, out_idx (n,)  closest t (t_max on a miss) and index (-1)
//   out_rows (40, n - row_from) winner rows of lanes >= row_from, column
//                        per lane so the writes coalesce; zeros on a miss
//   out_occ  (n,) u8     any-hit mode only
//
// Arithmetic: tri_tile.cuh, shared with job_sweep.cu (the multi-tile
// path), so both kernels and the plain PyTorch version
// (webgpu_raytracer_tpu_torch/ops/dense.py) agree bit for bit.
//
// What bounds it on an H100. By bytes, the fused per-bounce call at
// cornell 512^2 (524,288 lanes x 40 triangles) moves ~63 MB: 17 MB of rays
// in, 42 MB of winner rows and 4 MB of t / idx out, ~19 us at 3.35 TB/s.
// Measured on an H100 80GB HBM3 at 700 W it takes ~0.10 ms, and the
// any-hit mode, which writes almost nothing, ~0.08 ms: the kernel is bound
// by instruction issue, not memory. Each ray spends ~85 instructions per
// triangle (25 shared-memory loads, ~45 separately rounded f32 operations,
// the tests), ~3,400 per ray, which is ~50 us of issue at full occupancy.
// The design keeps the triangle data off the memory path: each
// 128-triangle tile is staged once per block in shared memory (25 floats a
// triangle, 12.8 KB) and read as warp-wide broadcasts; rows are written
// lane-minor so a warp stores 128 contiguous bytes per row. Blocks whose
// lanes are all inactive, or all already occluded in any-hit mode, stop
// walking tiles. Fusing the multiply-adds (and giving up bit-equality with
// the plain version) would cut issue. Multi-tile scenes do not come here:
// they take the job-stream path (job_sweep.cu behind a cluster cull), and
// this kernel's walk over every tile serves single-tile scenes and
// chip_smoke.py's cross-check of that path.

#include <cuda_runtime.h>

#include "tri_tile.cuh"

namespace {

using namespace wrt;

constexpr int kThreads = 256;  // rays per block

__global__ void __launch_bounds__(kThreads)
dense_sweep_kernel(const float* __restrict__ features, int tw, int valid,
                   const float* __restrict__ shade,
                   const float* __restrict__ rays8, int n, float t_min,
                   int any_hit, int row_from, float* __restrict__ out_t,
                   int* __restrict__ out_idx, float* __restrict__ out_rows,
                   unsigned char* __restrict__ out_occ) {
  __shared__ float tri[kFeat][kTile];

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = lane < n;
  float r[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (in_range) {
    for (int k = 0; k < 7; ++k) r[k] = rays8[(size_t)k * n + lane];
  }
  const Ray ray = make_ray(r);
  const float t_max = r[6];
  float best_t = t_max;
  int best_i = -1;
  bool occ = false;
  const bool active = in_range && t_max > 0.f;

  for (int base = 0; base < valid; base += kTile) {
    const bool want = active && !(any_hit && occ);
    // Also the barrier that retires the previous tile's shared reads.
    if (!__syncthreads_or(want)) break;
    const int cnt = min(kTile, valid - base);
    stage_tile(tri, features, tw, base, cnt);
    __syncthreads();
    if (!want) continue;
    walk_tile(tri, cnt, base, ray, t_min, t_max, any_hit, best_t, best_i,
              occ);
  }

  if (!in_range) return;
  if (any_hit) {
    out_occ[lane] = occ ? 1 : 0;
    return;
  }
  out_t[lane] = best_t;
  out_idx[lane] = best_i;
  if (out_rows != nullptr && lane >= row_from) {
    write_row(shade, best_i, out_rows, (size_t)(n - row_from),
              (size_t)(lane - row_from));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). any_hit != 0
// writes out_occ only; otherwise out_t / out_idx, and out_rows when it is
// not null.
extern "C" int wrt_dense_sweep(const float* features, int tw,
                               int valid_count, const float* shade,
                               const float* rays8, int n, float t_min,
                               int any_hit, int row_from_lane, float* out_t,
                               int* out_idx, float* out_rows,
                               unsigned char* out_occ, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    dense_sweep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        features, tw, valid_count, shade, rays8, n, t_min, any_hit,
        row_from_lane, out_t, out_idx, out_rows, out_occ);
  }
  return (int)cudaGetLastError();
}
