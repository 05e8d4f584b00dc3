// The exact culls of the multi-tile paths: for each group of g
// coherence-sorted lanes, the 128-triangle tiles ("clusters") whose
// bounding sphere some lane's segment (t_min, t_clip) can touch.
// - cluster_cull_kernel (the job-stream path): the survivors in ascending
//   id and their count.
// - cluster_cull_keyed_kernel (the scan path, whose groups are its
//   1024-lane ray tiles): per cluster the least distance, in world units,
//   at which a lane of the group can touch it, 3e38 where none can. The
//   wrapper sorts these keys (one torch.sort over (T, ct), as the JAX
//   package sorts them outside any kernel) into near-to-far worklists.
//
// Not a Pallas kernel in the JAX package: there it is XLA,
// webgpu_raytracer_tpu/ops/cluster_cull.py::tile_cluster_worklist_exact
// (with_keys=False for the job-stream path, with_keys=True for the scan
// path), a dense (lanes x clusters) pair test that XLA fuses. Eager PyTorch
// would write every intermediate of that test to memory, so the culls have
// these kernels. Their plain versions are in
// webgpu_raytracer_tpu_torch/ops/cluster_cull.py, and kernel and plain
// version give the same worklists and keys: every product, sum, root and
// quotient below is a separately rounded f32 operation (__fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn) in the plain version's
// order.
//
// Per lane: dd = |d|^2; the slab exit t_exit of the live spheres' box
// (scene_box.cuh); t_clip = min(t_max, max(t_exit, 0)), 0 for a dead lane.
// Per (lane, cluster [c, r]), in ray-parameter units: oc = o - c,
// b = d . oc, cc = |oc|^2 - r^2, disc = b^2 - dd cc.
// - Unkeyed, sqrt-free: the pair passes when disc >= 0, t_clip > 0, r >= 0,
//   (a_lo <= 0 or disc >= a_lo^2) and (b_hi >= 0 or disc >= b_hi^2), with
//   a_lo = dd (t_min (1 - 1e-6)) + b and b_hi = dd (t_clip (1 + 1e-6)) + b:
//   the ends nudged outward, so rounding can only admit a cluster.
// - Keyed, the sqrt form, not nudged (as the JAX package has it): sq =
//   sqrt(max(disc, 0)); the pair passes when disc >= 0, t_clip > 0,
//   r >= 0, -b + sq >= dd t_min and -b - sq <= dd t_clip; its key is
//   max((-b - sq) / dd * |d|, 0).
//
// Layout: spheres (ct, 4) f32 [cx, cy, cz, r] (r < 0: an all-padding
// tile); rays_s (8, rp) f32, rp = G * g; order (G, ct) i32 of which only
// the first counts[group] entries are written; counts (G,) i32; keys
// (G, ct) f32, all written.
//
// What bounds them on an H100: operations, ~25 f32 operations a pair test
// (a root and a quotient more when keyed) over lanes x clusters (~1e9
// pairs, ~26 GFLOP, at the fused 512^2 bounce of the 2,009-cluster spheres
// scene); their bytes are the rays once and the worklists or keys. The
// design: one block per group; the group's live lanes (t_clip > 0) are
// compacted into shared memory once with their per-lane terms, so a dead
// group costs one pass over its rays and a partly dead one tests only its
// live lanes; each thread then takes one cluster of a g-wide chunk and
// walks the live lanes as shared-memory broadcasts. Unkeyed, it stops at
// the first lane that passes, and a block-wide prefix sum over the chunk's
// flags places the survivors in ascending id. Keyed, it walks every live
// lane and keeps the least key in a register: the thread owns its cluster,
// so the group-wide minimum needs no reduction.

#include <cuda_runtime.h>

#include "scene_box.cuh"
#include "tri_tile.cuh"

namespace {

using namespace wrt;

constexpr int kTerms = 9;   // per staged lane: o, d, dd, lo_term, hi_term
constexpr int kKeyTerms = 10;  // keyed: o, d, dd, dd t_min, dd t_clip, |d|

// Exclusive prefix sum of flag over the block, and the block's total.
// scratch holds one int per warp. Every thread of the block calls it.
__device__ __forceinline__ int block_prefix(bool flag, int* scratch,
                                            int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned bits = __ballot_sync(0xffffffffu, flag);
  const int before = __popc(bits & ((1u << lane) - 1u));
  __syncthreads();  // scratch is free again
  if (lane == 0) scratch[warp] = __popc(bits);
  __syncthreads();
  int offset = 0;
  total = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = scratch[w];
    if (w < warp) offset += c;
    total += c;
  }
  return offset + before;
}

// This thread's lane of its block's group: r[0..6] = [d, o, t_max],
// dd = |d|^2, and the returned t_clip (0 for a dead lane). Every thread of
// the block calls it.
__device__ __forceinline__ float lane_clip(const float4* __restrict__ spheres,
                                           int ct,
                                           const float* __restrict__ rays_s,
                                           int rp, BoxScratch& box, float* r,
                                           float& dd) {
  float lo[3], hi[3];
  block_scene_box(spheres, ct, box, lo, hi);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < 7; ++k) r[k] = rays_s[(size_t)k * rp + l];
  dd = add(add(mul(r[0], r[0]), mul(r[1], r[1])), mul(r[2], r[2]));
  float t_enter, t_exit;
  slab_interval(r, lo, hi, t_enter, t_exit);
  return r[6] > 0.f ? fminf(r[6], fmaxf(t_exit, 0.f)) : 0.f;
}

__global__ void __launch_bounds__(1024)
cluster_cull_kernel(const float4* __restrict__ spheres, int ct,
                    const float* __restrict__ rays_s, int rp, float a_lo_k,
                    float hi_k, int* __restrict__ order,
                    int* __restrict__ counts) {
  extern __shared__ float lanes[];  // (kTerms, blockDim.x)
  __shared__ BoxScratch box;
  __shared__ int scratch[32];

  const int g = blockDim.x;
  const int group = blockIdx.x;

  // 1. This lane's terms; the live ones go to shared memory, compacted.
  float r[7], dd;
  const float t_clip = lane_clip(spheres, ct, rays_s, rp, box, r, dd);
  const bool live = t_clip > 0.f;
  int n_live;
  const int slot = block_prefix(live, scratch, n_live);
  if (live) {
    const float terms[kTerms] = {r[3], r[4], r[5], r[0], r[1], r[2], dd,
                                 mul(dd, a_lo_k), mul(dd, mul(t_clip, hi_k))};
    for (int k = 0; k < kTerms; ++k) lanes[k * g + slot] = terms[k];
  }
  __syncthreads();

  // 2. Clusters in chunks of g, one a thread; survivors in ascending id.
  int* list = order + (size_t)group * ct;
  int n_out = 0;
  for (int base = 0; n_live > 0 && base < ct; base += g) {
    const int c = base + threadIdx.x;
    bool pass = false;
    if (c < ct) {
      const float4 s = spheres[c];
      if (s.w >= 0.f) {
        for (int j = 0; j < n_live && !pass; ++j) {
          pass = touches(lanes[j], lanes[g + j], lanes[2 * g + j],
                         lanes[3 * g + j], lanes[4 * g + j], lanes[5 * g + j],
                         lanes[6 * g + j], lanes[7 * g + j],
                         lanes[8 * g + j], s);
        }
      }
    }
    int total;
    const int at = block_prefix(pass, scratch, total);
    if (pass) list[n_out + at] = c;
    n_out += total;
  }
  if (threadIdx.x == 0) counts[group] = n_out;
}

__global__ void __launch_bounds__(1024)
cluster_cull_keyed_kernel(const float4* __restrict__ spheres, int ct,
                          const float* __restrict__ rays_s, int rp,
                          float t_min, float* __restrict__ keys) {
  extern __shared__ float lanes[];  // (kKeyTerms, blockDim.x)
  __shared__ BoxScratch box;
  __shared__ int scratch[32];

  const int g = blockDim.x;
  float r[7], dd;
  const float t_clip = lane_clip(spheres, ct, rays_s, rp, box, r, dd);
  const bool live = t_clip > 0.f;
  int n_live;
  const int slot = block_prefix(live, scratch, n_live);
  if (live) {
    const float terms[kKeyTerms] = {r[3], r[4], r[5], r[0], r[1], r[2], dd,
                                    mul(dd, t_min), mul(dd, t_clip),
                                    __fsqrt_rn(dd)};
    for (int k = 0; k < kKeyTerms; ++k) lanes[k * g + slot] = terms[k];
  }
  __syncthreads();

  float* row = keys + (size_t)blockIdx.x * ct;
  for (int c = threadIdx.x; c < ct; c += g) {
    const float4 s = spheres[c];
    float key = kBig;
    for (int j = 0; s.w >= 0.f && j < n_live; ++j) {
      const float ocx = sub(lanes[j], s.x), ocy = sub(lanes[g + j], s.y),
                  ocz = sub(lanes[2 * g + j], s.z);
      const float dx = lanes[3 * g + j], dy = lanes[4 * g + j],
                  dz = lanes[5 * g + j], ddj = lanes[6 * g + j];
      const float b = add(add(mul(dx, ocx), mul(dy, ocy)), mul(dz, ocz));
      const float cc =
          sub(add(add(mul(ocx, ocx), mul(ocy, ocy)), mul(ocz, ocz)),
              mul(s.w, s.w));
      const float disc = sub(mul(b, b), mul(ddj, cc));
      if (!(disc >= 0.f)) continue;
      const float sq = __fsqrt_rn(disc);
      const float nb = -b;
      if (!(add(nb, sq) >= lanes[7 * g + j])) continue;
      const float near = sub(nb, sq);
      if (!(near <= lanes[8 * g + j])) continue;
      key = fminf(key, fmaxf(mul(__fdiv_rn(near, ddj), lanes[9 * g + j]),
                             0.f));
    }
    row[c] = key;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). One block of
// g threads per group (g a multiple of 32, at most 1024; rp = G * g).
extern "C" int wrt_cluster_cull(const float* spheres, int ct,
                                const float* rays_s, int rp, int g,
                                float a_lo_scale, float hi_nudge, int* order,
                                int* counts, void* stream) {
  if (rp > 0) {
    const size_t smem = sizeof(float) * kTerms * g;
    cluster_cull_kernel<<<rp / g, g, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(spheres), ct, rays_s, rp, a_lo_scale,
        hi_nudge, order, counts);
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success). One block of
// g threads per group (g a multiple of 32, at most 1024; rp = G * g);
// writes all of keys (G, ct).
extern "C" int wrt_cluster_cull_keyed(const float* spheres, int ct,
                                      const float* rays_s, int rp, int g,
                                      float t_min, float* keys,
                                      void* stream) {
  if (rp > 0) {
    const size_t smem = sizeof(float) * kKeyTerms * g;
    cluster_cull_keyed_kernel<<<rp / g, g, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(spheres), ct, rays_s, rp, t_min, keys);
  }
  return (int)cudaGetLastError();
}
