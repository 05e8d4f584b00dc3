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
// gather. Here one block serves one ray tile, one thread one sorted lane,
// and each tile of the f32 features table that survives is staged in
// shared memory and walked with tri_tile.cuh, the arithmetic of
// dense_sweep.cu. None of the queue, the batches, the short-drain zeroing,
// the windows or the mirror rows is carried over.
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
//   stats   (T, 3) i32   optional [entries scanned, entries processed,
//                        worklist length] per tile; null writes none
//
// Per worklist entry k, in order:
// 1. Each lane holds its own reach in world units, min(open |d|, wcap):
//    open is its best t so far (t_max before a hit), or 0 once occluded in
//    any-hit mode or for a dead lane; wcap is its exit of the scene box
//    (scene_box.cuh), 0 for a lane that misses the box. One
//    __syncthreads_or(key[k] <= reach) is the sorted early exit: some lane
//    reaches the key exactly when the tile's largest reach does, and the
//    keys ascend, so the TPU kernel's cached scalar and its refresh need no
//    reduction here.
// 2. One __syncthreads_or(touches) is the scan-side cull: a cluster that no
//    lane's open segment (t_min, open) can touch is neither staged nor
//    walked. A lane whose own test fails skips the walk (the TPU kernel's
//    window gate, at lane grain).
// 3. The survivors' tiles are walked with commits on t < best, or t == best
//    from a lower triangle index: clusters do not come in ascending id
//    here, and the port's rule is that the lowest index wins an exact tie.
// Rounding may only admit a cluster: the per-lane test is the nudged
// sqrt-free tri_tile.cuh::touches (the cull's and the job kernel's), and
// the reach is widened by the same factor in the early exit. Both drop only
// clusters that cannot hold a hit inside the lane's open segment, so t, idx
// and rows are bit-equal to dense_sweep.cu walking every tile, and to
// job_sweep.cu, whatever the order of near-equal keys.
//
// What bounds it on an H100: instruction throughput, like the other
// sweeps (~85 instructions per ray and triangle) over the (warp, cluster)
// pairs in which some lane of the warp touches the cluster; per scanned
// entry a block also pays two barriers and the sphere test (~30
// instructions a lane), and per processed entry the staging of 12.8 KB.
// Bytes are small beside it (32 B of ray in and 168 B out a lane, the
// tiles mostly from L2). The design: near-to-far order lowers each lane's
// best t early, so later clusters fail the lane's test and the tile's
// reach shrinks until the early exit ends the walk; a tile of dead lanes
// has an empty worklist and stops at once. Against that, a block is 1,024
// threads wide: two blocks fill an SM, and a tile's worklist is walked by
// one block in sequence, so the longest worklist bounds the launch.
//
// Measured on an H100 80GB HBM3 at 700 W, on the fused bounce-1 sweep of
// spheres 512^2 (524,288 lanes, 127,524 live, 126 non-empty ray tiles):
// 24.8 ms, where job_sweep.cu takes 13.8 ms and the bound is 0.18 ms. The
// worklist of a 1,024-lane tile holds 618 clusters on average (a 128-lane
// job group's 215), and the walk is cut little: the early exit never
// fired, and 90% of the entries are processed. 43% of the live lanes hit
// nothing there (rays to the sky, unoccluded shadow rays), so their reach
// stays at the scene box's exit, which covers every key they gave their
// tile; one such lane among 1,024 keeps the whole worklist alive, and
// near-to-far order only shortens the lanes that hit.

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
  __shared__ float tri[kFeat][kTile];
  __shared__ BoxScratch box;

  const int tile = blockIdx.x;
  const int lane = tile * blockDim.x + threadIdx.x;  // < rp
  float lo[3], hi[3];
  block_scene_box(spheres, ct, box, lo, hi);
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
  const float dlen = __fsqrt_rn(dd);
  const float lo_term = mul(dd, a_lo_k);
  float t_enter, t_exit;
  slab_interval(r, lo, hi, t_enter, t_exit);
  const float wcap =
      mul(t_enter <= t_exit && t_exit > 0.f ? t_exit : 0.f, dlen);

  const int count = counts[tile];
  const int* list = order + (size_t)tile * ct;
  const float* key = keys + (size_t)tile * ct;
  int scanned = 0, processed = 0;
  for (int k = 0; k < count; ++k) {
    const bool want = active && !(any_hit && occ);
    const float open = any_hit ? t_max : best_t;
    const float reach = mul(fminf(mul(open, dlen), wcap), hi_k);
    // Also the barrier that retires the previous cluster's shared reads.
    if (!__syncthreads_or(want && key[k] <= reach)) break;
    ++scanned;
    const int cluster = list[k];
    const bool touch =
        want && touches(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, dd,
                        lo_term, mul(dd, mul(open, hi_k)), spheres[cluster]);
    if (!__syncthreads_or(touch)) continue;
    ++processed;
    const int base = cluster * kTile;
    const int cnt = max(0, min(kTile, valid - base));
    stage_tile(tri, features, tw, base, cnt);
    __syncthreads();
    if (!touch) continue;
    walk_tile<true>(tri, cnt, base, ray, t_min, t_max, any_hit, best_t,
                    best_i, occ);
  }
  if (stats != nullptr && threadIdx.x == 0) {
    stats[3 * tile] = scanned;
    stats[3 * tile + 1] = processed;
    stats[3 * tile + 2] = count;
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
// m threads per ray tile (m a multiple of 32, at most 1024; rp = T * m).
// any_hit != 0 writes out_occ only; otherwise out_t / out_idx, and out_rows
// when it is not null. stats may be null.
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
  if (rp > 0) {
    scan_sweep_kernel<<<rp / m, m, 0, (cudaStream_t)stream>>>(
        features, tw, valid_count, shade, rays_s, rp, perm, n_out, order,
        keys, counts, reinterpret_cast<const float4*>(spheres), ct, t_min,
        a_lo_scale, hi_nudge, any_hit, row_from_lane, out_t, out_idx,
        out_rows, out_occ, stats);
  }
  return (int)cudaGetLastError();
}
