// Exact per-group cluster worklists of the multi-tile path: for each group
// of g coherence-sorted lanes, the 128-triangle tiles ("clusters") whose
// bounding sphere some lane's segment (t_min, t_clip) can touch, in
// ascending id, and their count.
//
// Not a Pallas kernel in the JAX package: there it is XLA,
// webgpu_raytracer_tpu/ops/cluster_cull.py::tile_cluster_worklist_exact
// with with_keys=False (the branch its job-stream path takes), a dense
// (lanes x clusters) pair test that XLA fuses. Eager PyTorch would write
// every intermediate of that test to memory, so the cull has this kernel.
// Its plain version is webgpu_raytracer_tpu_torch/ops/cluster_cull.py, and
// the two give the same worklists: every product, sum and quotient below is
// a separately rounded f32 operation (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn) in the plain version's order.
//
// Per lane: dd = |d|^2; the slab exit t_exit of the live spheres' box
// (direction components below 1e-20 in magnitude count as +-1e-20);
// t_clip = min(t_max, max(t_exit, 0)), 0 for a dead lane. Per (lane,
// cluster [c, r]), in ray-parameter units, sqrt-free: oc = o - c,
// b = d . oc, cc = |oc|^2 - r^2, disc = b^2 - dd cc; the pair passes when
// disc >= 0, t_clip > 0, r >= 0, (a_lo <= 0 or disc >= a_lo^2) and
// (b_hi >= 0 or disc >= b_hi^2), with a_lo = dd (t_min (1 - 1e-6)) + b and
// b_hi = dd (t_clip (1 + 1e-6)) + b: the ends nudged outward, so rounding
// can only admit a cluster.
//
// Layout: spheres (ct, 4) f32 [cx, cy, cz, r] (r < 0: an all-padding
// tile); rays_s (8, rp) f32, rp = G * g; order (G, ct) i32 of which only
// the first counts[group] entries are written; counts (G,) i32.
//
// What bounds it on an H100: operations, ~25 f32 operations a pair test
// over lanes x clusters (~1e9 pairs, ~26 GFLOP, at the fused 512^2 bounce
// of the 2,009-cluster spheres scene); its bytes are the rays once and the
// worklists. The design: one block per group; the group's live lanes
// (t_clip > 0) are compacted into shared memory once with their
// per-lane terms, so a dead group costs one pass over its rays and a
// partly dead one tests only its live lanes; each thread then takes one
// cluster of a g-wide chunk and walks the live lanes as shared-memory
// broadcasts, stopping at the first lane that passes; a block-wide prefix
// sum over the chunk's flags places the survivors in ascending id.

#include <cuda_runtime.h>

#include "tri_tile.cuh"

namespace {

using namespace wrt;

constexpr float kBig = 3e38f;
constexpr int kTerms = 9;  // per staged lane: o, d, dd, lo_term, hi_term

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

__global__ void __launch_bounds__(1024)
cluster_cull_kernel(const float4* __restrict__ spheres, int ct,
                    const float* __restrict__ rays_s, int rp, float a_lo_k,
                    float hi_k, int* __restrict__ order,
                    int* __restrict__ counts) {
  extern __shared__ float lanes[];  // (kTerms, blockDim.x)
  __shared__ float box[2][3][32];   // per-warp partial lo / hi
  __shared__ int scratch[32];

  const int g = blockDim.x;
  const int group = blockIdx.x;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int n_warps = g >> 5;

  // 1. The box of the live spheres (min of c - r, max of c + r).
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
  for (int c = threadIdx.x; c < ct; c += g) {
    const float4 s = spheres[c];
    if (s.w >= 0.f) {
      const float cs[3] = {s.x, s.y, s.z};
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], sub(cs[a], s.w));
        hi[a] = fmaxf(hi[a], add(cs[a], s.w));
      }
    }
  }
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
    if (wl == 0) {
      box[0][a][warp] = lo[a];
      box[1][a][warp] = hi[a];
    }
  }
  __syncthreads();
  for (int a = 0; a < 3; ++a) {
    lo[a] = box[0][a][0];
    hi[a] = box[1][a][0];
    for (int w = 1; w < n_warps; ++w) {
      lo[a] = fminf(lo[a], box[0][a][w]);
      hi[a] = fmaxf(hi[a], box[1][a][w]);
    }
  }

  // 2. This lane's terms; the live ones go to shared memory, compacted.
  const int l = group * g + threadIdx.x;
  float r[7];
  for (int k = 0; k < 7; ++k) r[k] = rays_s[(size_t)k * rp + l];
  const float dd = add(add(mul(r[0], r[0]), mul(r[1], r[1])),
                       mul(r[2], r[2]));
  float t_exit = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float d = r[a], o = r[3 + a];
    const float d_safe =
        fabsf(d) > 1e-20f ? d : (d >= 0.f ? 1e-20f : -1e-20f);
    const float t1 = __fdiv_rn(sub(lo[a], o), d_safe);
    const float t2 = __fdiv_rn(sub(hi[a], o), d_safe);
    const float far = fmaxf(t1, t2);
    t_exit = a == 0 ? far : fminf(t_exit, far);
  }
  const float t_max = r[6];
  const float t_clip = t_max > 0.f ? fminf(t_max, fmaxf(t_exit, 0.f)) : 0.f;
  const bool live = t_clip > 0.f;
  int n_live;
  const int slot = block_prefix(live, scratch, n_live);
  if (live) {
    const float terms[kTerms] = {r[3], r[4], r[5], r[0], r[1], r[2], dd,
                                 mul(dd, a_lo_k), mul(dd, mul(t_clip, hi_k))};
    for (int k = 0; k < kTerms; ++k) lanes[k * g + slot] = terms[k];
  }
  __syncthreads();

  // 3. Clusters in chunks of g, one a thread; survivors in ascending id.
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
