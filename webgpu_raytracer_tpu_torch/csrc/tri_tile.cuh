// The per-triangle ray test shared by dense_sweep.cu, job_sweep.cu and
// scan_sweep.cu, so the three kernels run the same arithmetic: a
// 128-triangle tile of the f32 features table staged in shared memory, then
// walked by one thread per ray. And the segment-sphere test shared by
// cluster_cull.cu, job_sweep.cu and scan_sweep.cu.
//
// features (16, 5*tw) f32, column groups [s0 | s1 | s2 | tn | td]. Per
// triangle: s_k = f . [d, o x d] (k = 0, 1, 2), tn = f . [o, 1], td = f . d
// (the table's fifth group, the CPU reference's choice, ops/dense.py), each
// dot product summed left to right with separately rounded f32 operations
// (__fmul_rn / __fadd_rn block FMA contraction). The plain PyTorch version
// (webgpu_raytracer_tpu_torch/ops/dense.py::_chunk_t) evaluates the same
// expression, so kernels and plain versions agree bit for bit. Inside test
// inclusive, |td| >= 1e-6, strict t_min < t < t_max; closest mode commits
// on strict < in ascending index order, so the lowest index wins exact ties
// when tiles come in ascending id; a kernel that takes them in another
// order (scan_sweep.cu) also commits an equal t from a lower index.

#pragma once

#include <cuda_runtime.h>

namespace wrt {

constexpr int kTile = 128;  // triangles per staged tile (a cull cluster)
constexpr int kFeat = 25;   // staged floats per triangle
constexpr int kShadeK = 40;

// Staged row q -> offset of (feature row, column group) in the features
// table: q 0-17: rows 0-5 of groups s0, s1, s2; q 18-21: rows 6-9 of tn;
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

__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

struct Ray {
  float dx, dy, dz, ox, oy, oz, mx, my, mz;
};

__device__ __forceinline__ Ray make_ray(const float* r) {
  Ray ray;
  ray.dx = r[0];
  ray.dy = r[1];
  ray.dz = r[2];
  ray.ox = r[3];
  ray.oy = r[4];
  ray.oz = r[5];
  ray.mx = __fsub_rn(mul(ray.oy, ray.dz), mul(ray.oz, ray.dy));
  ray.my = __fsub_rn(mul(ray.oz, ray.dx), mul(ray.ox, ray.dz));
  ray.mz = __fsub_rn(mul(ray.ox, ray.dy), mul(ray.oy, ray.dx));
  return ray;
}

// Stage triangles [base, base + cnt) into tri; every thread of the block
// takes part. The 25 rows are 128 contiguous floats each, so loads
// coalesce. The caller synchronises before and after.
__device__ __forceinline__ void stage_tile(float (*tri)[kTile],
                                           const float* __restrict__ features,
                                           int tw, int base, int cnt) {
  for (int e = threadIdx.x; e < kFeat * kTile; e += blockDim.x) {
    const int q = e / kTile, j = e % kTile;
    if (j < cnt) tri[q][j] = features[feat_offset(q, tw) + base + j];
  }
}

// Walk a staged tile of cnt triangles (global indices base + j). Closest
// mode lowers (best_t, best_i) on strict <, and with kAnyOrder (tiles not
// in ascending id) also on an equal t from a lower index; any-hit mode sets
// occ at the first hit inside (t_min, t_max) and stops.
template <bool kAnyOrder = false>
__device__ __forceinline__ void walk_tile(float (*tri)[kTile], int cnt,
                                          int base, const Ray& r, float t_min,
                                          float t_max, bool any_hit,
                                          float& best_t, int& best_i,
                                          bool& occ) {
  for (int j = 0; j < cnt; ++j) {
    float s[3];
    for (int g = 0; g < 3; ++g) {
      const int q = 6 * g;
      s[g] = add(add(add(add(add(mul(r.dx, tri[q][j]),
                                 mul(r.dy, tri[q + 1][j])),
                             mul(r.dz, tri[q + 2][j])),
                         mul(r.mx, tri[q + 3][j])),
                     mul(r.my, tri[q + 4][j])),
                 mul(r.mz, tri[q + 5][j]));
    }
    const float td = add(add(mul(r.dx, tri[22][j]), mul(r.dy, tri[23][j])),
                         mul(r.dz, tri[24][j]));
    const bool inside = fminf(fminf(s[0], s[1]), s[2]) >= 0.f ||
                        fmaxf(fmaxf(s[0], s[1]), s[2]) <= 0.f;
    if (!inside || !(fabsf(td) >= 1e-6f)) continue;
    const float tn = add(add(add(mul(r.ox, tri[18][j]), mul(r.oy, tri[19][j])),
                             mul(r.oz, tri[20][j])),
                         tri[21][j]);
    const float t = __fdiv_rn(tn, td);
    if (!(t > t_min)) continue;
    if (any_hit) {
      if (t < t_max) {
        occ = true;
        return;
      }
    } else if (t < best_t ||
               (kAnyOrder && t == best_t && base + j < best_i)) {
      best_t = t;
      best_i = base + j;
    }
  }
}

// Can the segment (t_min, t_hi) of the ray o + t d touch the sphere
// s = [c, r] (a tile's bounding sphere)? In ray-parameter units through
// dd = |d|^2 and sqrt-free: oc = o - c, b = d . oc, cc = |oc|^2 - r^2,
// disc = b^2 - dd cc; true when disc >= 0, (a_lo <= 0 or disc >= a_lo^2)
// and (b_hi >= 0 or disc >= b_hi^2), with a_lo = lo_term + b and
// b_hi = hi_term + b, where lo_term = dd (t_min (1 - 1e-6)) and
// hi_term = dd (t_hi (1 + 1e-6)) are rounded products: the ends nudged
// outward, so rounding only admits. Separately rounded f32 operations in
// the order of webgpu_raytracer_tpu_torch/ops/cluster_cull.py::pair_ok.
// The caller tests r >= 0 and t_hi > 0.
__device__ __forceinline__ bool touches(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float dd, float lo_term,
                                        float hi_term, float4 s) {
  const float ocx = sub(ox, s.x), ocy = sub(oy, s.y), ocz = sub(oz, s.z);
  const float b = add(add(mul(dx, ocx), mul(dy, ocy)), mul(dz, ocz));
  const float cc = sub(add(add(mul(ocx, ocx), mul(ocy, ocy)), mul(ocz, ocz)),
                       mul(s.w, s.w));
  const float disc = sub(mul(b, b), mul(dd, cc));
  if (!(disc >= 0.f)) return false;
  const float a_lo = add(lo_term, b);
  if (!(a_lo <= 0.f || disc >= mul(a_lo, a_lo))) return false;
  const float b_hi = add(hi_term, b);
  return b_hi >= 0.f || disc >= mul(b_hi, b_hi);
}

// The winner's shade row into column c of the (40, rn) row output, zeros
// on a miss; a warp's stores of one row are contiguous when its lanes are.
__device__ __forceinline__ void write_row(const float* __restrict__ shade,
                                          int best_i, float* __restrict__ rows,
                                          size_t rn, size_t c) {
  const float* src = shade + (size_t)(best_i < 0 ? 0 : best_i) * kShadeK;
  for (int k = 0; k < kShadeK; ++k) {
    rows[k * rn + c] = best_i >= 0 ? src[k] : 0.f;
  }
}

}  // namespace wrt
