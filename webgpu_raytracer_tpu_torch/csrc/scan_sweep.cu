// Scan narrow phase of the multi-tile path: per ray tile of m
// coherence-sorted lanes, the closest hit (with the winner's shade row) or
// any-hit occlusion over the tile's keyed cull worklist (cluster_cull.cu,
// sorted near to far), with a per-lane cull against the running best and a
// sorted early exit.
//
// Replaces webgpu_raytracer_tpu/ops/pallas_dense.py::_kernel2 (launched by
// _run2; TuneConfig.narrow = "scan" there, narrow="scan" here). It computes
// what that kernel computes, not its mechanism. The TPU kernel scans the
// worklist ahead of a DMA queue of bf16x3 operand blocks, intersects queued
// clusters as stacked MXU matmuls, gates the epilogue per 128-lane window
// of vreg-tiled cull operands, caches the tile's open intervals and its
// scalar reach in scratch, and fetches winner rows with a one-hot matmul
// into a block whose mirror rows carry t and idx to one un-permuting
// gather. Here one block serves one ray tile and one thread owns one sorted
// lane, each cluster of the f32 features table that survives is staged in
// shared memory, and the lanes that touch it are walked one warp to a
// (lane, cluster) pair with tri_tile.cuh, the arithmetic of dense_sweep.cu.
// None of the DMA queue, the batches, the short-drain zeroing, the windows
// or the mirror rows is carried over.
//
// Layout:
//   rays_s  (8, rp) f32  sorted ray stack [d, o, t_max, pad], rp = T * m
//   perm    (rp,) i32    sorted lane l is caller lane perm[l]; >= n_out
//                        marks padding, which writes nothing
//   order   (T, ct) i32  worklists: the first counts[tile] entries are
//                        cluster ids, near to far
//   keys    (T, ct) f32  their keys, ascending: the least distance in world
//                        units at which a lane of the tile can touch the
//                        cluster
//   spheres (ct, 4) f32  the clusters' bounding spheres [cx, cy, cz, r]
//   out_t, out_idx (n_out,), out_rows (40, n_out - row_from), out_occ
//                        (n_out,) u8: written at the caller's lane order
//                        (out_t[perm[l]]), rows only for lanes >= row_from
//   stats   (T, 4) i32   optional [entries scanned, entries processed,
//                        worklist length, (lane, cluster) pairs walked] per
//                        tile; null writes none
//
// Per worklist entry k, in order:
// 1. Each lane holds its own reach in world units, min(open |d|, wcap):
//    open is its best t so far (t_max before a hit), or 0 once occluded in
//    any-hit mode or for a dead lane; wcap is its exit of the scene box
//    (scene_box.cuh), 0 for a lane that misses the box. It tests its open
//    segment (t_min, open) against the cluster's sphere and, if it can
//    touch it, appends itself to the block's queue. One
//    __syncthreads_or(key[k] <= reach) is the sorted early exit: some lane
//    reaches the key exactly when the tile's largest reach does, and the
//    keys ascend, so the TPU kernel's cached scalar and its refresh need no
//    reduction here. The same barrier publishes the queue and the staged
//    cluster (each thread waits for its own part of the copy just before
//    it) and retires the previous entry.
// 2. The copy of entry k + 1's cluster starts (cp.async into the other of
//    two buffers; only the next entry, as the early exit may end the
//    list), to land behind this entry's walk. An empty queue is the
//    scan-side cull: a cluster that no lane's open segment can touch is
//    not walked and not counted as processed; it costs its copy.
// 3. The block's warps take the queued lanes in turn, one warp walking the
//    cluster for one lane (coop_walk, the TPU kernel's window gate at lane
//    grain), and the owners commit, after the barrier that ends the entry,
//    on t < best, or t == best from a lower triangle index: clusters do not
//    come in ascending id here, and the port's rule is that the lowest
//    index wins an exact tie.
// Rounding may only admit a cluster: the per-lane test is the nudged
// sqrt-free tri_tile.cuh::touches (the cull's and the job kernel's), and
// the reach is widened by the same factor in the early exit. Both drop only
// clusters that cannot hold a hit inside the lane's open segment, so t, idx
// and rows are bit-equal to dense_sweep.cu walking every tile, and to
// job_sweep.cu, whatever the order of near-equal keys.
//
// What bounds it on an H100: the length of the longest worklists. A block
// is 1,024 threads wide and walks its tile's worklist in sequence behind
// up to two barriers an entry, and on the fused bounce-1 sweep of spheres
// 512^2 (524,288 lanes, 127,524 live) only 126 ray tiles are non-empty, so
// one block an SM on 126 of the 132 SMs; a tile's worklist holds 618
// clusters on average and 1,240 at most (a 128-lane job group's 215). The
// walk is cut little by the order: the early exit never fires there, and
// 90% of the entries are processed, because 43% of the live lanes hit
// nothing (rays to the sky, unoccluded shadow rays) and their reach stays
// at the scene box's exit; one such lane among 1,024 keeps the whole
// worklist alive. What the design does: per entry a lane pays the sphere
// test and the queue (~60 instructions), and only the ~3% of lanes whose
// segment touches the cluster are walked, one warp each, so the 32 warps
// drain a queue in a round or two where the walk by one thread per ray
// that this kernel replaced spent a 128-triangle walk of every warp that
// held one touching lane; the next cluster's 12.8 KB load behind the walk.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, on that sweep: 2.90 ms
// (any-hit 2.43 ms) where the walk by one thread per ray took 24.7 ms and
// job_sweep.cu takes 1.74 ms, against a bound of 0.18 ms. 2,191,798 pairs
// are walked (2,096,545 needed, 72.1 M offered by the processed entries):
// near-to-far order walks 5% fewer pairs than the job kernel's id order,
// and the sequential worklists cost more than that saves: an entry takes
// ~2.3 us of its SM (the sphere test and the loop on 32 warps, then ~31
// queued lanes at ~300 warp-instructions each), and the longest list is
// twice the mean. 64 registers, no spills; 65.4 KB of shared memory a
// 1,024-thread block (dynamic, past the 48 KB default).

#include <cuda_runtime.h>

#include "scene_box.cuh"
#include "tri_tile.cuh"

namespace {

using namespace wrt;

__global__ void __launch_bounds__(1024)
scan_sweep_kernel(const float* __restrict__ features, int tw, int valid,
                  const float* __restrict__ shade,
                  const float* __restrict__ rays_s, int rp,
                  const int* __restrict__ perm, int n_out,
                  const int* __restrict__ order,
                  const float* __restrict__ keys,
                  const int* __restrict__ counts,
                  const float4* __restrict__ spheres, int ct, float t_min,
                  float a_lo_k, float hi_k, int any_hit, int row_from,
                  float* __restrict__ out_t, int* __restrict__ out_idx,
                  float* __restrict__ out_rows,
                  unsigned char* __restrict__ out_occ,
                  int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char scratch[];
  __shared__ BoxScratch box;
  const int B = blockDim.x, tid = threadIdx.x;
  const WalkScratch s = walk_scratch(scratch, B);

  const int tile = blockIdx.x;
  const int lane = tile * B + tid;  // < rp
  float lo[3], hi[3];
  block_scene_box(spheres, ct, box, lo, hi);
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
  const float dlen = __fsqrt_rn(dd);
  const float lo_term = mul(dd, a_lo_k);
  float t_enter, t_exit;
  slab_interval(r, lo, hi, t_enter, t_exit);
  const float wcap =
      mul(t_enter <= t_exit && t_exit > 0.f ? t_exit : 0.f, dlen);

  const int count = counts[tile];
  const int* list = order + (size_t)tile * ct;
  const float* key = keys + (size_t)tile * ct;
  if (count > 0) stage_tile_async(s, 0, features, list[0] * kTile);
  cp_async_commit();
  int scanned = 0, processed = 0, pairs = 0;
  for (int k = 0; k < count; ++k) {
    const bool want = active && !(any_hit && occ);
    const float open = any_hit ? t_max : best_t;
    const float reach = mul(fminf(mul(open, dlen), wcap), hi_k);
    const int cluster = list[k];
    const bool touch =
        want && touches(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, dd,
                        lo_term, mul(dd, mul(open, hi_k)), spheres[cluster]);
    queue_push(touch, s.queue, &s.count[k % 3]);
    cp_async_wait();  // this thread's part of the staged tile
    // Publishes the queue and the staged tile; retires the previous
    // entry's walk and commits.
    if (!__syncthreads_or(want && key[k] <= reach)) break;
    ++scanned;
    const int nq = walk_entry(s, features, valid, k, cluster,
                              k + 1 < count ? list[k + 1] : -1, t_min);
    if (nq == 0) continue;
    ++processed;
    pairs += nq;
    if (!touch) continue;
    const unsigned t_bits = s.res_t[tid];
    const float t = __uint_as_float(t_bits);
    if (t_bits == kMiss) continue;
    if (any_hit) {
      occ = t < t_max;
    } else if (t < best_t || (t == best_t && s.res_i[tid] < best_i)) {
      best_t = t;
      best_i = s.res_i[tid];
    }
  }
  cp_async_wait();
  if (stats != nullptr && tid == 0) {
    stats[4 * tile] = scanned;
    stats[4 * tile + 1] = processed;
    stats[4 * tile + 2] = count;
    stats[4 * tile + 3] = pairs;
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
// m threads per ray tile (m a multiple of 32, at most 1024; rp = T * m).
// any_hit != 0 writes out_occ only; otherwise out_t / out_idx, and out_rows
// when it is not null. stats may be null. t_min must not be negative,
// features 16-byte aligned and tw a multiple of 4.
extern "C" int wrt_scan_sweep(const float* features, int tw, int valid_count,
                              const float* shade, const float* rays_s, int rp,
                              int m, const int* perm, int n_out,
                              const int* order, const float* keys,
                              const int* counts, const float* spheres, int ct,
                              float t_min, float a_lo_scale, float hi_nudge,
                              int any_hit, int row_from_lane, float* out_t,
                              int* out_idx, float* out_rows,
                              unsigned char* out_occ, int* stats,
                              void* stream) {
  if (rp <= 0) return 0;
  if (!(t_min >= 0.f) || tw % 4 != 0 ||
      reinterpret_cast<size_t>(features) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // Past the 48 KB a kernel gets unasked at m = 1024.
  const size_t bytes = walk_scratch_bytes(m);
  const cudaError_t err = cudaFuncSetAttribute(
      scan_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  scan_sweep_kernel<<<rp / m, m, bytes, (cudaStream_t)stream>>>(
      features, tw, valid_count, shade, rays_s, rp, perm, n_out, order, keys,
      counts, reinterpret_cast<const float4*>(spheres), ct, t_min, a_lo_scale,
      hi_nudge, any_hit, row_from_lane, out_t, out_idx, out_rows, out_occ,
      stats);
  return (int)cudaGetLastError();
}
