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
// one block serves one group and one thread owns one sorted lane, each
// worklisted tile of the f32 features table is staged in shared memory, and
// the lanes that touch it are walked one warp to a (lane, tile) pair with
// tri_tile.cuh, the arithmetic of dense_sweep.cu.
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
//   stats   (G, 3) i32   optional [tiles walked, (lane, tile) pairs walked,
//                        worklist length] per group; null writes none
//
// Per worklist entry k, in order (tiles in ascending id):
// 1. Each lane tests its own open segment, (t_min, best t so far) or
//    (t_min, t_max) in any-hit mode, against the tile's sphere
//    (tri_tile.cuh::touches, the cull's test) and, if it can touch it,
//    appends itself to the block's queue. One __syncthreads_or ends the
//    group when no lane is live (dead lanes sort to the end of their
//    segment) or, in any-hit mode, all are occluded; the same barrier
//    publishes the queue and the staged tile (each thread waits for its own
//    part of the copy just before it) and retires the previous tile.
// 2. The copy of entry k + 1's tile starts (cp.async into the other of two
//    buffers), to land behind this tile's walk. A tile that no lane touches
//    is not walked and not counted: it costs its copy.
// 3. The block's warps take the queued lanes in turn, one warp walking the
//    tile for one lane (coop_walk), and the owners commit on t < best after
//    the barrier that ends the tile, so a lane's best t is final before the
//    next tile's test reads it.
// A lane that cannot touch a tile's sphere inside its segment cannot hit
// inside it, the per-triangle t are those of dense_sweep.cu, and the tile's
// winner is the least t at the lowest index: t, idx and rows are bit-equal
// to dense_sweep.cu walking every tile, which commits on strict < in
// ascending index order. Left out, as TPU-only: the bf16x3 operands, the
// DMA queue and its short-drain zeroing, the t / idx mirror rows, the
// one-hot row matmul and the row-major un-permute gather.
//
// What bounds it on an H100: instruction issue over the (lane, tile) pairs
// walked, ~300 warp-instructions a pair (4 triangles a thread: 25 16-byte
// shared-memory loads, ~180 separately rounded f32 operations, the tests,
// the ray fetch and two reductions), plus ~60 instructions a lane and two
// barriers a walked tile for the test, the queue and the commit; and the
// longest worklist, which one block walks in sequence. Bytes are small beside it (32 B of ray in and 168 B out a lane,
// 12.8 KB of triangles per (group, tile), mostly from L2, loaded behind the
// previous tile's walk). The design spends the walk only where it is
// needed: on the fused bounce-1 sweep of spheres 512^2 a group's worklist
// offers each lane 215 tiles and the lane's segment touches 8% of them, so
// the walk by one thread per ray that this kernel replaced spent a
// 128-triangle walk of a whole warp on ~2.5 useful lanes. The row writes
// scatter through perm (each lane's 40 floats land at its caller
// position).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, on that sweep (524,288
// lanes, 127,524 live; 997 non-empty groups, 214,082 (group, tile) jobs):
// 1.74 ms (any-hit 1.36 ms) where the walk by one thread per ray took 13.8
// ms, against a bound of 0.18 ms. 2,299,142 pairs are walked in 199,206 of
// the jobs: 2,096,545 are needed (the pairs a lane's segment up to its
// final hit touches) and 27.4 M were offered. 63 registers, no spills; 30.6
// KB of shared memory a 128-thread block, so 7 blocks an SM. What is left:
// ~0.8 G warp-instructions would take ~0.9 ms spread evenly over the SMs,
// but one block walks a worklist in sequence (~11.5 queued lanes a walked
// tile are three rounds of its four warps), and the longest (732 tiles,
// 3.4x the mean) takes 1.09 ms alone on its SM
// (tools/torch_narrow_times.py times that group).

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
                 unsigned char* __restrict__ out_occ,
                 int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char scratch[];
  const int B = blockDim.x, tid = threadIdx.x;
  const WalkScratch s = walk_scratch(scratch, B);

  const int group = blockIdx.x;
  const int lane = group * B + tid;  // < rp
  float r[7];
  walk_begin(s, rays_s, rp, lane, tw, r);
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
  if (count > 0) stage_tile_async(s, 0, features, list[0] * kTile);
  cp_async_commit();
  int walked = 0, pairs = 0;
  for (int k = 0; k < count; ++k) {
    const bool want = active && !(any_hit && occ);
    const float hi_term = mul(dd, mul(any_hit ? t_max : best_t, hi_k));
    const int tile = list[k];
    const bool touch =
        want && touches(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, dd,
                        lo_term, hi_term, spheres[tile]);
    queue_push(touch, s.queue, &s.count[k % 3]);
    cp_async_wait();  // this thread's part of the staged tile
    // Publishes the queue and the staged tile; retires the previous
    // tile's walk and commits.
    if (!__syncthreads_or(want)) break;
    const int nq = walk_entry(s, features, valid, k, tile,
                              k + 1 < count ? list[k + 1] : -1, t_min);
    if (nq == 0) continue;
    ++walked;
    pairs += nq;
    if (!touch) continue;
    const unsigned t_bits = s.res_t[tid];
    const float t = __uint_as_float(t_bits);
    if (t_bits == kMiss) continue;
    if (any_hit) {
      occ = t < t_max;
    } else if (t < best_t) {
      best_t = t;
      best_i = s.res_i[tid];
    }
  }
  cp_async_wait();
  if (stats != nullptr && tid == 0) {
    stats[3 * group] = walked;
    stats[3 * group + 1] = pairs;
    stats[3 * group + 2] = count;
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

// Returns the first CUDA error of the launch (0 on success). One block of
// g threads per group (g a multiple of 32, at most 1024; rp = G * g).
// any_hit != 0 writes out_occ only; otherwise out_t / out_idx, and out_rows
// when it is not null. stats may be null. t_min must not be negative,
// features 16-byte aligned and tw a multiple of 4.
extern "C" int wrt_job_sweep(const float* features, int tw, int valid_count,
                             const float* shade, const float* rays_s, int rp,
                             int g, const int* perm, int n_out,
                             const int* order, const int* counts,
                             const float* spheres, int ct, float t_min,
                             float a_lo_scale, float hi_nudge, int any_hit,
                             int row_from_lane, float* out_t, int* out_idx,
                             float* out_rows, unsigned char* out_occ,
                             int* stats, void* stream) {
  if (rp <= 0) return 0;
  if (!(t_min >= 0.f) || tw % 4 != 0 ||
      reinterpret_cast<size_t>(features) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // Past the 48 KB a kernel gets unasked from g = 640.
  const size_t bytes = walk_scratch_bytes(g);
  const cudaError_t err = cudaFuncSetAttribute(
      job_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  job_sweep_kernel<<<rp / g, g, bytes, (cudaStream_t)stream>>>(
      features, tw, valid_count, shade, rays_s, rp, perm, n_out, order,
      counts, reinterpret_cast<const float4*>(spheres), ct, t_min,
      a_lo_scale, hi_nudge, any_hit, row_from_lane, out_t, out_idx,
      out_rows, out_occ, stats);
  return (int)cudaGetLastError();
}
