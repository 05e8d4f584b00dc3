// Job-stream narrow phase of the multi-tile path: per group of g
// coherence-sorted lanes, the closest hit (with the winner's shade row) or
// any-hit occlusion over only the 128-triangle tiles on the group's cull
// worklist (cluster_cull.cu).
//
// Replaces webgpu_raytracer_tpu/ops/pallas_dense.py::_kernel3 (launched by
// _run3). It computes what that kernel computes, not its mechanism: the TPU
// kernel streams each worklisted cluster's bf16x3 operand block into VMEM
// through a DMA queue, intersects it as one MXU matmul and fetches winner
// rows with a one-hot matmul, then the caller un-permutes the rows; here
// one block serves one group, one thread one sorted lane, and each
// worklisted tile of the f32 features table is staged in shared memory and
// walked with tri_tile.cuh, the arithmetic of dense_sweep.cu.
//
// Layout:
//   rays_s  (8, rp) f32  sorted ray stack [d, o, t_max, pad], rp = G * g
//   perm    (rp,) i32    sorted lane l is caller lane perm[l]; >= n_out
//                        marks padding, which writes nothing
//   order   (G, ct) i32  worklists: the first counts[group] entries are
//                        tile ids in ascending order
//   spheres (ct, 4) f32  the tiles' bounding spheres [cx, cy, cz, r]
//   out_t, out_idx (n_out,), out_rows (40, n_out - row_from), out_occ
//                        (n_out,) u8: written at the caller's lane order
//                        (out_t[perm[l]]), rows only for lanes >= row_from
//
// Tiles go in ascending id, triangles in ascending index, commits on
// strict <: t and idx are bit-equal to dense_sweep.cu walking every tile,
// because the cull only drops tiles that no lane of the group can hit
// inside (t_min, t_max). Left out, as TPU-only: the bf16x3 operands, the DMA
// queue and its short-drain zeroing, the t / idx mirror rows, the one-hot
// row matmul and the row-major un-permute gather.
//
// What bounds it on an H100: instruction issue, like dense_sweep.cu (~85
// instructions per ray and triangle), over sum_groups count * g * 128 ray x
// triangle tests; bytes are small beside it (32 B of ray in and 168 B out a
// lane, 12.8 KB of triangles per (group, tile), mostly from L2). The
// design: lanes sorted by direction bin and origin cell share short
// worklists; a group whose worklist is empty, or whose lanes are all dead
// (they sort to the end of their segment) or, in any-hit mode, all
// occluded, stops at once. A group's worklist is the union of its lanes'
// needs, so before walking a staged tile each lane tests its own segment
// (t_min, best t so far; t_max in any-hit mode) against the tile's sphere
// (tri_tile.cuh::touches, the cull's test) and skips the walk when it
// cannot touch it: a warp whose 32 lanes all skip costs ~25 instructions a
// lane instead of ~11,000. The skip drops only tiles that cannot hold a
// hit inside the segment, so results stay bit-equal. The row writes
// scatter through perm (each lane's 40 floats land at its caller
// position).

#include <cuda_runtime.h>

#include "tri_tile.cuh"

namespace {

using namespace wrt;

__global__ void __launch_bounds__(1024)
job_sweep_kernel(const float* __restrict__ features, int tw, int valid,
                 const float* __restrict__ shade,
                 const float* __restrict__ rays_s, int rp,
                 const int* __restrict__ perm, int n_out,
                 const int* __restrict__ order,
                 const int* __restrict__ counts,
                 const float4* __restrict__ spheres, int ct, float t_min,
                 float a_lo_k, float hi_k, int any_hit, int row_from,
                 float* __restrict__ out_t,
                 int* __restrict__ out_idx, float* __restrict__ out_rows,
                 unsigned char* __restrict__ out_occ) {
  __shared__ float tri[kFeat][kTile];

  const int group = blockIdx.x;
  const int lane = group * blockDim.x + threadIdx.x;  // < rp
  float r[7];
  for (int k = 0; k < 7; ++k) r[k] = rays_s[(size_t)k * rp + lane];
  const Ray ray = make_ray(r);
  const float t_max = r[6];
  float best_t = t_max;
  int best_i = -1;
  bool occ = false;
  const bool active = t_max > 0.f;
  const float dd = add(add(mul(ray.dx, ray.dx), mul(ray.dy, ray.dy)),
                       mul(ray.dz, ray.dz));
  const float lo_term = mul(dd, a_lo_k);

  const int count = counts[group];
  const int* list = order + (size_t)group * ct;
  for (int k = 0; k < count; ++k) {
    const bool want = active && !(any_hit && occ);
    // Also the barrier that retires the previous tile's shared reads.
    if (!__syncthreads_or(want)) break;
    const int tile = list[k];
    const int base = tile * kTile;
    const int cnt = max(0, min(kTile, valid - base));
    stage_tile(tri, features, tw, base, cnt);
    __syncthreads();
    if (!want) continue;
    const float hi_term = mul(dd, mul(any_hit ? t_max : best_t, hi_k));
    if (!touches(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, dd, lo_term,
                 hi_term, spheres[tile])) {
      continue;
    }
    walk_tile(tri, cnt, base, ray, t_min, t_max, any_hit, best_t, best_i,
              occ);
  }

  const int p = perm[lane];
  if (p >= n_out) return;
  if (any_hit) {
    out_occ[p] = occ ? 1 : 0;
    return;
  }
  out_t[p] = best_t;
  out_idx[p] = best_i;
  if (out_rows != nullptr && p >= row_from) {
    write_row(shade, best_i, out_rows, (size_t)(n_out - row_from),
              (size_t)(p - row_from));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). One block of
// g threads per group (g a multiple of 32, at most 1024; rp = G * g).
// any_hit != 0 writes out_occ only; otherwise out_t / out_idx, and out_rows
// when it is not null.
extern "C" int wrt_job_sweep(const float* features, int tw, int valid_count,
                             const float* shade, const float* rays_s, int rp,
                             int g, const int* perm, int n_out,
                             const int* order, const int* counts,
                             const float* spheres, int ct, float t_min,
                             float a_lo_scale, float hi_nudge, int any_hit,
                             int row_from_lane, float* out_t, int* out_idx,
                             float* out_rows, unsigned char* out_occ,
                             void* stream) {
  if (rp > 0) {
    job_sweep_kernel<<<rp / g, g, 0, (cudaStream_t)stream>>>(
        features, tw, valid_count, shade, rays_s, rp, perm, n_out, order,
        counts, reinterpret_cast<const float4*>(spheres), ct, t_min,
        a_lo_scale, hi_nudge, any_hit, row_from_lane, out_t, out_idx,
        out_rows, out_occ);
  }
  return (int)cudaGetLastError();
}
