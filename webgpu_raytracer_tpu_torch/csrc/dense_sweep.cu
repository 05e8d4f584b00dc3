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
// Arithmetic: s_k = f . [d, o x d], tn = f . [o, 1], td = f . d with td the
// table's fifth group (the CPU reference's choice, ops/dense.py), each dot
// product summed left to right with separately rounded f32 operations
// (__fmul_rn / __fadd_rn block FMA contraction). The plain PyTorch version
// (webgpu_raytracer_tpu_torch/ops/dense.py) evaluates the same expression,
// so the two agree bit for bit. Inside test inclusive, |td| >= 1e-6,
// strict t_min < t < t_max; closest mode commits on strict < in ascending
// index order, so the lowest index wins exact ties.
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
// the plain version) or culling tiles by bounding sphere would cut issue.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // triangles staged per shared-memory tile
constexpr int kThreads = 256;  // rays per block
constexpr int kFeat = 25;      // staged floats per triangle
constexpr int kShadeK = 40;

// Staged row q -> (feature row, column group) of the features table:
// q 0-17: rows 0-5 of groups s0, s1, s2; q 18-21: rows 6-9 of tn;
// q 22-24: rows 0-2 of td.
__device__ __forceinline__ int feat_offset(int q, int tw) {
  int row, group;
  if (q < 18) {
    row = q % 6;
    group = q / 6;
  } else if (q < 22) {
    row = 6 + (q - 18);
    group = 3;
  } else {
    row = q - 22;
    group = 4;
  }
  return row * 5 * tw + group * tw;
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

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
  const float dx = r[0], dy = r[1], dz = r[2];
  const float ox = r[3], oy = r[4], oz = r[5], t_max = r[6];
  const float mx = __fsub_rn(mul(oy, dz), mul(oz, dy));
  const float my = __fsub_rn(mul(oz, dx), mul(ox, dz));
  const float mz = __fsub_rn(mul(ox, dy), mul(oy, dx));

  float best_t = t_max;
  int best_i = -1;
  bool occ = false;
  const bool active = in_range && t_max > 0.f;

  for (int base = 0; base < valid; base += kTile) {
    const bool want = active && !(any_hit && occ);
    // Also the barrier that retires the previous tile's shared reads.
    if (!__syncthreads_or(want)) break;
    const int cnt = min(kTile, valid - base);
    for (int e = threadIdx.x; e < kFeat * kTile; e += blockDim.x) {
      const int q = e / kTile, j = e % kTile;
      if (j < cnt) tri[q][j] = features[feat_offset(q, tw) + base + j];
    }
    __syncthreads();
    if (!want) continue;
    for (int j = 0; j < cnt; ++j) {
      float s[3];
      for (int g = 0; g < 3; ++g) {
        const int q = 6 * g;
        s[g] = add(add(add(add(add(mul(dx, tri[q][j]), mul(dy, tri[q + 1][j])),
                                   mul(dz, tri[q + 2][j])),
                               mul(mx, tri[q + 3][j])),
                           mul(my, tri[q + 4][j])),
                   mul(mz, tri[q + 5][j]));
      }
      const float td = add(add(mul(dx, tri[22][j]), mul(dy, tri[23][j])),
                           mul(dz, tri[24][j]));
      const bool inside =
          fminf(fminf(s[0], s[1]), s[2]) >= 0.f ||
          fmaxf(fmaxf(s[0], s[1]), s[2]) <= 0.f;
      if (!inside || !(fabsf(td) >= 1e-6f)) continue;
      const float tn = add(add(add(mul(ox, tri[18][j]), mul(oy, tri[19][j])),
                               mul(oz, tri[20][j])),
                           tri[21][j]);
      const float t = __fdiv_rn(tn, td);
      if (!(t > t_min)) continue;
      if (any_hit) {
        if (t < t_max) {
          occ = true;
          break;
        }
      } else if (t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
  }

  if (!in_range) return;
  if (any_hit) {
    out_occ[lane] = occ ? 1 : 0;
    return;
  }
  out_t[lane] = best_t;
  out_idx[lane] = best_i;
  if (out_rows != nullptr && lane >= row_from) {
    const size_t rn = (size_t)(n - row_from);
    const size_t c = (size_t)(lane - row_from);
    const float* src = shade + (size_t)(best_i < 0 ? 0 : best_i) * kShadeK;
    for (int k = 0; k < kShadeK; ++k) {
      out_rows[k * rn + c] = best_i >= 0 ? src[k] : 0.f;
    }
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
