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
// Per lane: dd = |d|^2; the slab exit t_exit of the live spheres' box (six
// floats [lo, hi] the caller computed once for the scene); t_clip =
// min(t_max, max(t_exit, 0)), 0 for a dead lane.
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
// tile); box (6,) f32; rays_s (8, rp) f32, rp = G * g; order (G, ct) i32 of
// which only the first counts[group] entries are written; counts (G,) i32;
// keys (G, ct) f32, all written.
//
// What bounds them on an H100: instruction throughput. ~25 f32 operations a
// pair test (a root and a quotient more when keyed) over live lanes x
// clusters (256 M pairs at the fused 512^2 bounce of the 2,009-cluster
// spheres scene), each a separately rounded operation, so one instruction
// apiece; their bytes are the rays once and the worklists or keys.
//
// The design. A thread keeps L lanes (4 where g allows) in registers: a
// warp covers a "subgroup" of 32 L lanes and walks clusters, one
// warp-uniform 16-byte shared-memory load of the sphere a step shared by
// the warp's 32 L pair tests (each warp stages its next 32 spheres while
// it walks the current ones: SphereSlots). The test runs in two stages:
// every lane computes disc; the interval part (and the keyed root and
// quotient) only when the warp's vote finds some disc >= 0, which one
// step in eight does. A dead lane carries NaN terms, so no comparison of
// its pairs holds and it needs no predicate of its own. Clusters go in
// aligned blocks of 32:
// - unkeyed: one block per group, of n_sub subgroups x `split` warps (at
//   least kCullWarps warps a block); the warps of a subgroup take the
//   32-cluster blocks in turn. A warp gathers
//   its votes in a register word and ORs it into a shared bit mask once a
//   32-cluster block; after one barrier a prefix over the words' popcounts
//   places the survivors in ascending id.
// - keyed: the grid's y takes slices of kSliceBlocks 32-cluster blocks, so
//   one 1,024-lane tile spreads over many blocks and each owns its
//   columns of `keys` outright; a warp that finds a survivor reduces its
//   keys' bits with __reduce_min_sync (keys are >= +0, so their bits order
//   as unsigned) and lane 0 takes an atomicMin on the block's shared row.
// OR and min give the same result in any order, so the outputs do not
// depend on how the warps interleave. A group with no live lane writes its
// zero count (its row of 3e38) and leaves before it reads a sphere; a warp
// with no live lane skips the walk.

#include <cuda_runtime.h>

#include "scene_box.cuh"
#include "tri_tile.cuh"

namespace {

using namespace wrt;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskWords = 1024;  // 32-cluster blocks a pass of the unkeyed
                                  // kernel (one pass up to 32,768 clusters)

// The block layouts, the fastest measured on an H100 (tools/
// torch_cull_probe.py builds this file with other values and times them):
// the least number of warps a block, the 32-cluster blocks a grid slice
// of the keyed kernel, and the blocks an SM that the launch bounds of each
// kernel at four lanes a thread ask for (0: left to ptxas). Three blocks
// of 256 threads hold the unkeyed kernel to 80 registers without the
// spill ptxas makes on its own; the keyed kernel is fastest left alone.
#ifndef WRT_CULL_WARPS
#define WRT_CULL_WARPS 8
#endif
#ifndef WRT_KEYED_SLICE_BLOCKS
#define WRT_KEYED_SLICE_BLOCKS 6
#endif
#ifndef WRT_CULL_MIN_BLOCKS
#define WRT_CULL_MIN_BLOCKS 3
#endif
#ifndef WRT_KEYED_MIN_BLOCKS
#define WRT_KEYED_MIN_BLOCKS 0
#endif
constexpr int kCullWarps = WRT_CULL_WARPS;
constexpr int kSliceBlocks = WRT_KEYED_SLICE_BLOCKS;

// The most warps a block of the kernels has, by lanes a thread (their
// launch bounds).
template <int L>
struct MaxWarps {
  static constexpr int value = L == 4 ? 8 : (L == 2 ? 16 : 32);
};

// A warp's two shared-memory slots of 32 spheres: while it walks one
// 32-cluster block out of one slot, its load of the next block (one
// coalesced 512-byte read, a sphere a thread) is in flight, so no step
// waits for device memory or the L2: a step reads its sphere as one
// 16-byte shared-memory broadcast.
struct SphereSlots {
  float4 s[2][32];
};

// Thread wl's sphere of the 32-cluster block at c0 (the last sphere again
// past the table's end, where no step reads it).
__device__ __forceinline__ float4 fetch_sphere(const float4* __restrict__
                                                   spheres,
                                               int ct, int c0, int wl) {
  return __ldg(spheres + min(c0 + wl, ct - 1));
}

// The terms of a thread's L lanes, lane j of the thread being lane
// first + 32 j of the sorted stack. lo and hi are the ends' rounded
// products with dd: unkeyed dd (t_min (1 - 1e-6)) and
// dd (t_clip (1 + 1e-6)); keyed dd t_min and dd t_clip, with dlen = |d|.
template <int L>
struct Lanes {
  float ox[L], oy[L], oz[L], dx[L], dy[L], dz[L], dd[L], lo[L], hi[L];
  float dlen[L];
};

// Does some lane of the block's group have t_max > 0? Every thread of the
// block calls it; it synchronises the block.
template <int L>
__device__ __forceinline__ bool group_alive(const float* __restrict__ rays_s,
                                            int rp, int first) {
  bool any = false;
  for (int j = 0; j < L; ++j) {
    any |= rays_s[(size_t)6 * rp + first + 32 * j] > 0.f;
  }
  return __syncthreads_or(any);
}

// Loads the thread's lanes; returns whether any of them is live
// (t_clip > 0). lo_k / hi_k scale the ends (see Lanes); keyed also fills
// dlen. A dead lane's origin is NaN: no comparison of its pairs holds.
template <int L, bool kKeyed>
__device__ __forceinline__ bool load_lanes(const float* __restrict__ rays_s,
                                           int rp, int first,
                                           const float* __restrict__ box,
                                           float lo_k, float hi_k,
                                           Lanes<L>& t) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __ldg(box + a);
    hi[a] = __ldg(box + 3 + a);
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float r[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) r[k] = rays_s[(size_t)k * rp + first + 32 * j];
    const float dd = add(add(mul(r[0], r[0]), mul(r[1], r[1])),
                         mul(r[2], r[2]));
    float t_enter, t_exit;
    slab_interval(r, lo, hi, t_enter, t_exit);
    const float t_clip = r[6] > 0.f ? fminf(r[6], fmaxf(t_exit, 0.f)) : 0.f;
    const bool live = t_clip > 0.f;
    any |= live;
    t.dx[j] = r[0];
    t.dy[j] = r[1];
    t.dz[j] = r[2];
    t.ox[j] = live ? r[3] : __int_as_float(0x7fc00000);
    t.oy[j] = r[4];
    t.oz[j] = r[5];
    t.dd[j] = dd;
    if (kKeyed) {
      t.lo[j] = mul(dd, lo_k);
      t.hi[j] = mul(dd, t_clip);
      t.dlen[j] = __fsqrt_rn(dd);
    } else {
      t.lo[j] = mul(dd, lo_k);
      t.hi[j] = mul(dd, mul(t_clip, hi_k));
    }
  }
  return any;
}

// Stage one of the pair test for the thread's lanes against sphere s:
// b and disc per lane; returns whether r >= 0 and some disc >= 0.
template <int L>
__device__ __forceinline__ bool discriminants(const Lanes<L>& t, float4 s,
                                              float* b, float* disc) {
  const float r2 = mul(s.w, s.w);
  bool some = false;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float ocx = sub(t.ox[j], s.x), ocy = sub(t.oy[j], s.y),
                ocz = sub(t.oz[j], s.z);
    b[j] = add(add(mul(t.dx[j], ocx), mul(t.dy[j], ocy)), mul(t.dz[j], ocz));
    const float cc =
        sub(add(add(mul(ocx, ocx), mul(ocy, ocy)), mul(ocz, ocz)), r2);
    disc[j] = sub(mul(b[j], b[j]), mul(t.dd[j], cc));
    some |= disc[j] >= 0.f;
  }
  return some & (s.w >= 0.f);
}

// Stage two, unkeyed: does some lane of the thread pass? Written without
// short-circuit operators, so it compiles to predicates, not branches.
template <int L>
__device__ __forceinline__ bool interval_pass(const Lanes<L>& t,
                                              const float* b,
                                              const float* disc) {
  bool pass = false;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float a_lo = add(t.lo[j], b[j]);
    const float b_hi = add(t.hi[j], b[j]);
    pass |= (disc[j] >= 0.f) &
            ((a_lo <= 0.f) | (disc[j] >= mul(a_lo, a_lo))) &
            ((b_hi >= 0.f) | (disc[j] >= mul(b_hi, b_hi)));
  }
  return pass;
}

// Stage two, keyed: the bits of the least key at which a lane of the warp
// can touch the sphere, those of 3e38 when none can. The same in every
// thread of the warp; all 32 call it together.
template <int L>
__device__ __forceinline__ unsigned warp_key(const Lanes<L>& t,
                                             const float* b,
                                             const float* disc) {
  float key = kBig;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (!(disc[j] >= 0.f)) continue;
    const float sq = __fsqrt_rn(disc[j]);
    const float nb = -b[j];
    if (!(add(nb, sq) >= t.lo[j])) continue;
    const float near = sub(nb, sq);
    if (!(near <= t.hi[j])) continue;
    key = fminf(key, fmaxf(mul(__fdiv_rn(near, t.dd[j]), t.dlen[j]), 0.f));
  }
  if (!__any_sync(kFull, key < kBig)) return __float_as_uint(kBig);
  return __reduce_min_sync(kFull, __float_as_uint(key));
}

// The walks take two clusters a step: stage one of both (2 L independent
// chains of arithmetic a thread), then one vote that sends the warp on
// when no lane has a disc >= 0 for either, as in most steps. An odd last
// cluster is taken twice, which changes neither an OR nor a minimum. The
// walks' loops are not unrolled: unrolled, both kernels were slower on the
// card, the keyed one (whose second stage is long) by up to a sixth.

template <int L>
__global__ void __launch_bounds__(32 * MaxWarps<L>::value,
                                  L == 4 ? WRT_CULL_MIN_BLOCKS : 0)
cluster_cull_kernel(const float4* __restrict__ spheres, int ct,
                    const float* __restrict__ rays_s, int rp, int g,
                    const float* __restrict__ box, float a_lo_k, float hi_k,
                    int* __restrict__ order, int* __restrict__ counts) {
  __shared__ unsigned mask[kMaskWords];
  __shared__ int before[kMaskWords];  // survivors ahead of a word's
  __shared__ int pass_total;
  __shared__ SphereSlots slots[MaxWarps<L>::value];

  const int group = blockIdx.x;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int n_sub = g / (32 * L);
  const int sub = warp % n_sub, turn = warp / n_sub, split = n_warps / n_sub;
  const int first = group * g + sub * 32 * L + wl;

  if (!group_alive<L>(rays_s, rp, first)) {
    if (threadIdx.x == 0) counts[group] = 0;
    return;
  }
  Lanes<L> t;
  const bool warp_live = __any_sync(
      kFull, load_lanes<L, false>(rays_s, rp, first, box, a_lo_k, hi_k, t));

  int* list = order + (size_t)group * ct;
  const int n_blocks = (ct + 31) >> 5;
  int n_out = 0;
  for (int base = 0; base < n_blocks; base += kMaskWords) {
    const int nw = min(kMaskWords, n_blocks - base);
    for (int i = threadIdx.x; i < nw; i += blockDim.x) mask[i] = 0u;
    __syncthreads();
    if (warp_live && turn < nw) {
      float4 ahead = fetch_sphere(spheres, ct, (base + turn) << 5, wl);
      int buf = 0;
      for (int i = turn; i < nw; i += split, buf ^= 1) {
        const int c0 = (base + i) << 5;
        const int n = min(32, ct - c0);
        const float4* sph = slots[warp].s[buf];
        slots[warp].s[buf][wl] = ahead;
        __syncwarp();
        if (i + split < nw) {
          ahead = fetch_sphere(spheres, ct, (base + i + split) << 5, wl);
        }
        unsigned word = 0u;
#pragma unroll 1
        for (int k = 0; k < n; k += 2) {
          const int k1 = min(k + 1, n - 1);
          const float4 s0 = sph[k], s1 = sph[k1];
          float b0[L], disc0[L], b1[L], disc1[L];
          const bool some0 = discriminants(t, s0, b0, disc0);
          const bool some1 = discriminants(t, s1, b1, disc1);
          if (!__any_sync(kFull, some0 | some1)) continue;
          const bool pass0 = interval_pass(t, b0, disc0) & (s0.w >= 0.f);
          const bool pass1 = interval_pass(t, b1, disc1) & (s1.w >= 0.f);
          if (__any_sync(kFull, pass0)) word |= 1u << k;
          if (__any_sync(kFull, pass1)) word |= 1u << k1;
        }
        if (word != 0u && wl == 0) atomicOr(&mask[i], word);
      }
    }
    __syncthreads();
    // Survivors in ascending id: warp 0 takes the exclusive prefix of the
    // words' popcounts, then every set bit knows its place.
    if (warp == 0) {
      int run = 0;
      for (int i0 = 0; i0 < nw; i0 += 32) {
        const int i = i0 + wl;
        const int c = i < nw ? __popc(mask[i]) : 0;
        int inc = c;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(kFull, inc, off);
          if (wl >= off) inc += v;
        }
        if (i < nw) before[i] = run + inc - c;
        run += __shfl_sync(kFull, inc, 31);
      }
      if (wl == 0) pass_total = run;
    }
    __syncthreads();
    for (int i = warp; i < nw; i += n_warps) {
      const unsigned m = mask[i];
      if ((m >> wl) & 1u) {
        list[n_out + before[i] + __popc(m & ((1u << wl) - 1u))] =
            ((base + i) << 5) + wl;
      }
    }
    n_out += pass_total;
    __syncthreads();  // mask, before and pass_total are free again
  }
  if (threadIdx.x == 0) counts[group] = n_out;
}

template <int L>
__global__ void __launch_bounds__(32 * MaxWarps<L>::value,
                                  L == 4 ? WRT_KEYED_MIN_BLOCKS : 0)
cluster_cull_keyed_kernel(const float4* __restrict__ spheres, int ct,
                          const float* __restrict__ rays_s, int rp, int g,
                          const float* __restrict__ box, float t_min,
                          int slice_blocks, float* __restrict__ keys) {
  extern __shared__ unsigned row[];  // (32 slice_blocks,) key bits
  __shared__ SphereSlots slots[MaxWarps<L>::value];

  const int group = blockIdx.x;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int n_sub = g / (32 * L);
  const int sub = warp % n_sub, turn = warp / n_sub, split = n_warps / n_sub;
  const int first = group * g + sub * 32 * L + wl;
  const int c_base = blockIdx.y * slice_blocks * 32;
  const int n_cols = min(slice_blocks * 32, ct - c_base);
  float* out = keys + (size_t)group * ct + c_base;

  if (!group_alive<L>(rays_s, rp, first)) {
    for (int i = threadIdx.x; i < n_cols; i += blockDim.x) out[i] = kBig;
    return;
  }
  for (int i = threadIdx.x; i < n_cols; i += blockDim.x) {
    row[i] = __float_as_uint(kBig);
  }
  Lanes<L> t;
  const bool warp_live = __any_sync(
      kFull, load_lanes<L, true>(rays_s, rp, first, box, t_min, 1.f, t));
  __syncthreads();
  if (warp_live && turn * 32 < n_cols) {
    float4 ahead = fetch_sphere(spheres, ct, c_base + turn * 32, wl);
    int buf = 0;
    for (int i0 = turn * 32; i0 < n_cols; i0 += split * 32, buf ^= 1) {
      const int n = min(32, n_cols - i0);
      const float4* sph = slots[warp].s[buf];
      slots[warp].s[buf][wl] = ahead;
      __syncwarp();
      if (i0 + split * 32 < n_cols) {
        ahead = fetch_sphere(spheres, ct, c_base + i0 + split * 32, wl);
      }
#pragma unroll 1
      for (int k = 0; k < n; k += 2) {
        const int k1 = min(k + 1, n - 1);
        const float4 s0 = sph[k], s1 = sph[k1];
        float b0[L], disc0[L], b1[L], disc1[L];
        const bool some0 = discriminants(t, s0, b0, disc0);
        const bool some1 = discriminants(t, s1, b1, disc1);
        if (!__any_sync(kFull, some0 | some1)) continue;
        if (__any_sync(kFull, some0)) {
          const unsigned bits = warp_key(t, b0, disc0);
          if (bits != __float_as_uint(kBig) && wl == 0) {
            atomicMin(&row[i0 + k], bits);
          }
        }
        if (__any_sync(kFull, some1)) {
          const unsigned bits = warp_key(t, b1, disc1);
          if (bits != __float_as_uint(kBig) && wl == 0) {
            atomicMin(&row[i0 + k1], bits);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_cols; i += blockDim.x) {
    out[i] = __uint_as_float(row[i]);
  }
}

// Lanes a thread: the most of 4, 2, 1 that divides g / 32.
int lanes_per_thread(int g) {
  const int w = g / 32;
  return w % 4 == 0 ? 4 : (w % 2 == 0 ? 2 : 1);
}

// Threads a block for groups of g lanes at L lanes a thread: every
// subgroup gets as many warps as bring the block to kCullWarps warps, short
// of the kernels' launch bounds.
int block_threads(int g, int L) {
  const int n_sub = g / (32 * L);
  const int most = L == 4 ? MaxWarps<4>::value
                          : (L == 2 ? MaxWarps<2>::value : MaxWarps<1>::value);
  int split = (kCullWarps + n_sub - 1) / n_sub;
  while (split > 1 && split * n_sub > most) --split;
  return 32 * n_sub * split;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). One block per
// group of g lanes (g a multiple of 32, at most 1024; rp = G * g).
extern "C" int wrt_cluster_cull(const float* spheres, int ct,
                                const float* rays_s, int rp, int g,
                                const float* box, float a_lo_scale,
                                float hi_nudge, int* order, int* counts,
                                void* stream) {
  if (rp > 0) {
    const int L = lanes_per_thread(g);
    const int threads = block_threads(g, L);
    const float4* sph = reinterpret_cast<const float4*>(spheres);
    cudaStream_t st = (cudaStream_t)stream;
    if (L == 4) {
      cluster_cull_kernel<4><<<rp / g, threads, 0, st>>>(
          sph, ct, rays_s, rp, g, box, a_lo_scale, hi_nudge, order, counts);
    } else if (L == 2) {
      cluster_cull_kernel<2><<<rp / g, threads, 0, st>>>(
          sph, ct, rays_s, rp, g, box, a_lo_scale, hi_nudge, order, counts);
    } else {
      cluster_cull_kernel<1><<<rp / g, threads, 0, st>>>(
          sph, ct, rays_s, rp, g, box, a_lo_scale, hi_nudge, order, counts);
    }
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 on success). A grid of
// (groups, slices of 32-cluster blocks); writes all of keys (G, ct).
extern "C" int wrt_cluster_cull_keyed(const float* spheres, int ct,
                                      const float* rays_s, int rp, int g,
                                      const float* box, float t_min,
                                      float* keys, void* stream) {
  if (rp > 0) {
    const int L = lanes_per_thread(g);
    const int threads = block_threads(g, L);
    const int n_blocks = (ct + 31) / 32;
    // kSliceBlocks a slice, more where the grid's y (at most 65,535
    // slices) could not hold them.
    int slice_blocks = kSliceBlocks;
    while ((n_blocks + slice_blocks - 1) / slice_blocks > 65535) {
      slice_blocks *= 2;
    }
    const dim3 grid(rp / g, (n_blocks + slice_blocks - 1) / slice_blocks);
    const size_t smem = sizeof(unsigned) * 32 * slice_blocks;
    const float4* sph = reinterpret_cast<const float4*>(spheres);
    cudaStream_t st = (cudaStream_t)stream;
    if (L == 4) {
      cluster_cull_keyed_kernel<4><<<grid, threads, smem, st>>>(
          sph, ct, rays_s, rp, g, box, t_min, slice_blocks, keys);
    } else if (L == 2) {
      cluster_cull_keyed_kernel<2><<<grid, threads, smem, st>>>(
          sph, ct, rays_s, rp, g, box, t_min, slice_blocks, keys);
    } else {
      cluster_cull_keyed_kernel<1><<<grid, threads, smem, st>>>(
          sph, ct, rays_s, rp, g, box, t_min, slice_blocks, keys);
    }
  }
  return (int)cudaGetLastError();
}
