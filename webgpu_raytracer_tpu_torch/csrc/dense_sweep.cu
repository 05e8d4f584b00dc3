// Dense rays x world-triangles sweep: closest hit with the winner's shade
// row, or any-hit occlusion.
//
// Replaces webgpu_raytracer_tpu/ops/pallas_dense.py::_kernel (launched by
// _run). It computes what that kernel computes, not its blocking: the TPU
// kernel evaluates the side tests as one bf16x3 MXU matmul per (2048-ray,
// triangle-tile) block and fetches winner rows with a one-hot matmul; here
// each thread walks the triangles in f32 for a few rays of its own.
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
// Arithmetic: the per-triangle expression of tri_tile.cuh (also coop_walk's,
// in job_sweep.cu and scan_sweep.cu) and of the plain PyTorch version
// (webgpu_raytracer_tpu_torch/ops/dense.py::_chunk_t), every product and
// sum rounded on its own, so the three sweeps and the plain version agree
// bit for bit.
//
// What bounds it on an H100. By bytes, the fused per-bounce call at
// cornell 512^2 (524,288 lanes x 36 triangles) moves ~63 MB: 17 MB of rays
// in, 42 MB of winner rows and 4 MB of t / idx out, ~19 us at 3.35 TB/s.
// By operations it is ~45 separately rounded f32 operations a (ray,
// triangle) pair, ~23 us at one operation an instruction on the call's
// live lanes: the kernel is bound by instruction issue, and by the memory
// phases that do not overlap it. Its first design (one ray a thread, every
// 256-ray block staging the tile) spent ~85 instructions a pair: 25 scalar
// shared-memory loads, the arithmetic, the tests, a divergent branch to
// the quotient. This one cuts what is not arithmetic:
// - a thread keeps up to kRays rays in registers, and each triangle datum
//   it loads serves all of them. The tile is staged triangle-major, 28
//   floats a triangle, and the pass over every pair reads only the 18 side
//   coefficients: four 16-byte and one 8-byte warp-wide broadcast a
//   triangle, ~5 / kRays loads a pair;
// - that pass has no branch: it takes the three side sums (33 operations)
//   and the inside test and keeps one bit a (ray, triangle) in a 32-bit
//   mask; td, tn and the quotient are taken after each 32 triangles, for
//   the bits set only, in ascending index order, so the result is the
//   sequential walk's. 44 instructions a pair (cuobjdump), 33 of them the
//   side sums;
// - a warp compacts the live lanes of its 32 x kRays (a lane with
//   t_max <= 0 is dead), so its work follows the live lanes, not the
//   stack: cornell's bounce-1 stacks are a third (512^2) to a half
//   (1080p) dead;
// - the grid is persistent (as many blocks as fit on the card), so a
//   one-tile scene stages its triangles, and in closest mode its shade
//   rows, once per block for the whole launch; after that no block-wide
//   barrier, so warps drift apart and one warp's loads and stores overlap
//   the others' walks;
// - results go back to each lane's owner through shared memory, and the
//   owners write t, idx and the winner's row from the staged rows (stride
//   41 floats, odd, so lanes that read different rows hit different
//   banks): a warp's stores of one row are 32 neighbouring words.
// On an NVIDIA H100 80GB HBM3 at 700 W the fused cornell call with rows
// takes 0.056 ms at 512^2 (the first design 0.077) and 0.26 ms on the real
// bounce-1 stack at 1920x1080 (0.40), bit for bit the same results.
// A warp with no live lane walks nothing; in any-hit mode a thread stops
// when its rays are all occluded. A scene of more than one tile
// (chip_smoke.py's cross-check of the narrow phases walks all 2,009 tiles
// of spheres) stages tile after tile for every chunk, with a block-wide
// early exit, and gathers the winners' rows from device memory
// (write_row); multi-tile scenes render through job_sweep.cu or
// scan_sweep.cu, not this kernel.
//
// Block shapes are constants; a probe (tools/torch_sweep_times.py
// --variants) builds others with -DWRT_SWEEP_THREADS=, -DWRT_SWEEP_RAYS=
// and -DWRT_SWEEP_MIN_BLOCKS=.

#include <cuda_runtime.h>

#include "tri_tile.cuh"

#ifndef WRT_SWEEP_THREADS
#define WRT_SWEEP_THREADS 256
#endif
#ifndef WRT_SWEEP_RAYS
#define WRT_SWEEP_RAYS 4
#endif
#ifndef WRT_SWEEP_MIN_BLOCKS
#define WRT_SWEEP_MIN_BLOCKS 2
#endif

namespace {

using namespace wrt;

constexpr int kThreads = WRT_SWEEP_THREADS;  // threads a block
constexpr int kRays = WRT_SWEEP_RAYS;        // rays a thread
constexpr int kChunk = kThreads * kRays;     // lanes a block takes at once
constexpr int kSub = 32 * kRays;             // of them a warp's
constexpr int kTri4 = 7;                     // float4 a staged triangle
constexpr int kRowStride = kShadeK + 1;      // floats a staged shade row
static_assert(kRays >= 1 && kRays <= 32, "rays a thread: a bit each");
static_assert(kThreads % 32 == 0, "whole warps");

// Where row q of feat_offset's order lands in a staged triangle: s0, s1,
// s2 (q 0-17) in order, the 18 floats every pair reads, then td (q 22-24)
// and tn (q 18-21), which only a candidate reads.
__device__ __forceinline__ int tri_slot(int q) {
  return q < 18 ? q : (q < 22 ? q + 3 : q - 4);
}

// Stage triangles [base, base + cnt) triangle-major into tri (kTri4 float4
// a triangle, the last three floats unused). Every thread of the block
// takes part; the 25 table rows are read coalesced, at the offsets in off.
// The caller synchronises before and after.
__device__ __forceinline__ void stage_tris(float* tri,
                                           const float* __restrict__ features,
                                           const int* off, int base, int cnt) {
  for (int e = threadIdx.x; e < kFeat * kTile; e += kThreads) {
    const int q = e / kTile, j = e % kTile;
    if (j < cnt) {
      tri[j * 4 * kTri4 + tri_slot(q)] = features[off[q] + base + j];
    }
  }
}

// Stage the shade rows of triangles [0, cnt) at kRowStride floats a row.
__device__ __forceinline__ void stage_rows(float* rows,
                                           const float* __restrict__ shade,
                                           int cnt) {
  for (int e = threadIdx.x; e < cnt * kShadeK; e += kThreads) {
    const int j = e / kShadeK;
    rows[j * kRowStride + (e - j * kShadeK)] = shade[e];
  }
}

struct Lane {
  Ray r;          // d, o and o x d (make_ray)
  float t_max;
  float best_t;   // t_max until a hit
  int best_i;     // -1 until a hit
};

// Walk cnt staged triangles (global indices base + j) for N rays of the
// thread, 32 triangles at a time. Bit k of `open` marks ray k as still
// walking: live, and in any-hit mode not yet occluded. First every ray
// takes the three side sums of the 32 triangles, with no branch, and keeps
// a bit a triangle it is inside of; then each ray takes, for those only
// and in ascending index order, td (a candidate needs |td| >= 1e-6), tn and
// the quotient (skipped where tn and td differ in sign: the quotient would
// be <= 0, or NaN, and fail t > t_min >= 0 all the same). Closest mode lowers
// (best_t, best_i) on strict <, so the lowest index wins an exact tie;
// any-hit mode clears a ray's bit at its first hit inside (t_min, t_max),
// and the walk ends when no bit is left.
template <bool kAnyHit, int N>
__device__ __forceinline__ void walk(const float* tri, int cnt, int base,
                                     float t_min, Lane (&ln)[N],
                                     unsigned& open) {
  for (int j0 = 0; j0 < cnt; j0 += 32) {
    const int jn = min(32, cnt - j0);
    unsigned cand[N];
#pragma unroll
    for (int k = 0; k < N; ++k) cand[k] = 0u;
    for (int jj = 0; jj < jn; ++jj) {
      const float* p = tri + (j0 + jj) * 4 * kTri4;
      const float4* p4 = reinterpret_cast<const float4*>(p);
      const float4 a = p4[0], b = p4[1], c = p4[2], d = p4[3];
      const float2 e = *reinterpret_cast<const float2*>(p + 16);
      const unsigned bit = 1u << jj;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const Ray& r = ln[k].r;
        const float s0 = add(add(add(add(add(mul(r.dx, a.x), mul(r.dy, a.y)),
                                             mul(r.dz, a.z)),
                                         mul(r.mx, a.w)),
                                     mul(r.my, b.x)),
                                 mul(r.mz, b.y));
        const float s1 = add(add(add(add(add(mul(r.dx, b.z), mul(r.dy, b.w)),
                                             mul(r.dz, c.x)),
                                         mul(r.mx, c.y)),
                                     mul(r.my, c.z)),
                                 mul(r.mz, c.w));
        const float s2 = add(add(add(add(add(mul(r.dx, d.x), mul(r.dy, d.y)),
                                             mul(r.dz, d.z)),
                                         mul(r.mx, d.w)),
                                     mul(r.my, e.x)),
                                 mul(r.mz, e.y));
        // Bitwise, not short-circuit: no branch around the second test.
        if ((fminf(fminf(s0, s1), s2) >= 0.f) |
            (fmaxf(fmaxf(s0, s1), s2) <= 0.f)) {
          cand[k] |= bit;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      unsigned m = (open >> k) & 1u ? cand[k] : 0u;
      const Ray& r = ln[k].r;
      while (m != 0u) {
        const int j = j0 + __ffs(m) - 1;
        m &= m - 1u;
        const float* p = tri + j * 4 * kTri4;
        const float td = add(add(mul(r.dx, p[18]), mul(r.dy, p[19])),
                             mul(r.dz, p[20]));
        if (!(fabsf(td) >= 1e-6f)) continue;
        const float tn = add(add(add(mul(r.ox, p[21]), mul(r.oy, p[22])),
                                 mul(r.oz, p[23])),
                             p[24]);
        if ((__float_as_uint(tn) ^ __float_as_uint(td)) >> 31) continue;
        const float t = __fdiv_rn(tn, td);
        if (!(t > t_min)) continue;
        if (kAnyHit) {
          if (t < ln[k].t_max) {
            open &= ~(1u << k);
            break;
          }
        } else if (t < ln[k].best_t) {
          ln[k].best_t = t;
          ln[k].best_i = base + j;
        }
      }
    }
    if (kAnyHit && open == 0u) return;
  }
}

// What a block shares: the staged tile, its staged shade rows, the
// features' row offsets; and per warp, in its kSub entries of the last
// three, the list of its live lanes and every lane's result.
template <bool kAnyHit>
struct Smem {
  alignas(16) float tri[kTile * 4 * kTri4];
  float rows[kAnyHit ? 1 : kTile * kRowStride];
  int off[kFeat];
  unsigned short live[kChunk];  // offsets (< kSub) of the live lanes
  float res_t[kChunk];          // by offset: t (t_max on a miss)
  int res_i[kChunk];            // and index (-1), or occluded (0 / 1)
};

struct Args {
  const float* __restrict__ features;
  const float* __restrict__ shade;
  const float* __restrict__ rays8;
  float* __restrict__ out_t;
  int* __restrict__ out_idx;
  float* __restrict__ out_rows;
  unsigned char* __restrict__ out_occ;
  int valid, n, row_from;
  float t_min;
  size_t rn;          // n - row_from: the rows' column count
  bool rows_staged;   // one tile, closest mode, rows wanted
};

// A warp's n_live live lanes (of the kSub at c0; `live` and the results
// at the warp's range of the shared arrays), N to a thread (entries l32,
// l32 + 32, ...; the last slot may be short), walked over every tile;
// each result left at its lane's offset. With more than one tile every
// warp of the block calls it with N = kRays, for the tiles' barriers.
template <bool kAnyHit, int N>
__device__ __forceinline__ void walk_lanes(Smem<kAnyHit>& sm, const Args& a,
                                           int c0, int n_live,
                                           const unsigned short* live,
                                           float* res_t, int* res_i) {
  const int l32 = threadIdx.x & 31;
  Lane ln[N];
  int off[N];
  unsigned open = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = k * 32 + l32;
    float r[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    off[k] = -1;
    if (e < n_live) {
      off[k] = live[e];
      for (int q = 0; q < 7; ++q) {
        r[q] = a.rays8[(size_t)q * a.n + c0 + off[k]];
      }
      open |= 1u << k;
    }
    ln[k].r = make_ray(r);
    ln[k].t_max = r[6];
    ln[k].best_t = r[6];
    ln[k].best_i = -1;
  }
  const unsigned was_open = open;
  if (a.valid <= kTile) {
    if (open) walk<kAnyHit, N>(sm.tri, a.valid, 0, a.t_min, ln, open);
  } else {
    for (int base = 0; base < a.valid; base += kTile) {
      // Also the barrier that retires the previous tile's shared reads.
      if (!__syncthreads_or(open != 0u)) break;
      const int cnt = min(kTile, a.valid - base);
      stage_tris(sm.tri, a.features, sm.off, base, cnt);
      __syncthreads();
      if (open) walk<kAnyHit, N>(sm.tri, cnt, base, a.t_min, ln, open);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (off[k] < 0) continue;
    res_t[off[k]] = ln[k].best_t;
    res_i[off[k]] = kAnyHit ? (int)(((was_open & ~open) >> k) & 1u)
                            : ln[k].best_i;
  }
}

// walk_lanes with N = slots (warp-uniform, 1 to kRays).
template <bool kAnyHit, int N>
__device__ __forceinline__ void walk_slots(int slots, Smem<kAnyHit>& sm,
                                           const Args& a, int c0, int n_live,
                                           const unsigned short* live,
                                           float* res_t, int* res_i) {
  if (slots == N) {
    walk_lanes<kAnyHit, N>(sm, a, c0, n_live, live, res_t, res_i);
  } else if constexpr (N > 1) {
    walk_slots<kAnyHit, N - 1>(slots, sm, a, c0, n_live, live, res_t,
                               res_i);
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, WRT_SWEEP_MIN_BLOCKS)
dense_sweep_kernel(const Args a, int tw) {
  __shared__ Smem<kAnyHit> sm;
  const int tid = threadIdx.x, w = tid >> 5, l32 = tid & 31;
  unsigned short* live = sm.live + w * kSub;
  float* res_t = sm.res_t + w * kSub;
  int* res_i = sm.res_i + w * kSub;

  if (tid < kFeat) sm.off[tid] = feat_offset(tid, tw);
  __syncthreads();
  if (a.valid <= kTile) {
    stage_tris(sm.tri, a.features, sm.off, 0, a.valid);
    if (a.rows_staged) stage_rows(sm.rows, a.shade, a.valid);
    __syncthreads();
  }

  // Each warp takes kSub lanes of every chunk of its block. On a one-tile
  // scene no barrier follows: the warps drift apart, and one's loads and
  // stores overlap the others' walks.
  for (int c = blockIdx.x * kChunk; c < a.n; c += gridDim.x * kChunk) {
    const int c0 = c + w * kSub;
    // Lane c0 + k * 32 + l32: a dead one (t_max <= 0, or past n) leaves
    // its result now, a live one takes its place in the warp's list.
    int n_live = 0;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int l = c0 + k * 32 + l32, o = k * 32 + l32;
      const float t_max = l < a.n ? a.rays8[(size_t)6 * a.n + l] : 0.f;
      const bool is_live = t_max > 0.f;
      const unsigned b = __ballot_sync(0xffffffffu, is_live);
      if (is_live) {
        live[n_live + __popc(b & ((1u << l32) - 1u))] = (unsigned short)o;
      } else {
        res_t[o] = t_max;
        res_i[o] = kAnyHit ? 0 : -1;
      }
      n_live += __popc(b);
    }
    __syncwarp();
    if (a.valid <= kTile) {
      walk_slots<kAnyHit, kRays>((n_live + 31) / 32, sm, a, c0, n_live,
                                 live, res_t, res_i);
    } else {
      walk_lanes<kAnyHit, kRays>(sm, a, c0, n_live, live, res_t, res_i);
    }
    __syncwarp();
    // Every lane's result, written by its owner: a warp's stores of one
    // output row are 32 neighbouring words.
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int l = c0 + k * 32 + l32, o = k * 32 + l32;
      if (l >= a.n) continue;
      const int bi = res_i[o];
      if (kAnyHit) {
        a.out_occ[l] = (unsigned char)bi;
        continue;
      }
      a.out_t[l] = res_t[o];
      a.out_idx[l] = bi;
      if (a.out_rows == nullptr || l < a.row_from) continue;
      const size_t col = (size_t)(l - a.row_from);
      if (a.rows_staged) {
        const float* src = sm.rows + max(bi, 0) * kRowStride;
        for (int q = 0; q < kShadeK; ++q) {
          a.out_rows[q * a.rn + col] = bi >= 0 ? src[q] : 0.f;
        }
      } else {
        write_row(a.shade, bi, a.out_rows, a.rn, col);
      }
    }
    // The list and the results are rewritten by the next lanes.
    __syncwarp();
  }
}

// Blocks of the persistent grid: as many as the card holds at once,
// computed once per device.
template <bool kAnyHit>
int resident_blocks() {
  constexpr int kDevices = 64;
  static int cached[kDevices];  // 0: not yet known
  int dev = 0;
  cudaGetDevice(&dev);
  int* slot = dev >= 0 && dev < kDevices ? &cached[dev] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dense_sweep_kernel<kAnyHit>, kThreads, 0);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (slot != nullptr) *slot = blocks;
  return blocks;
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
    const int chunks = (n + kChunk - 1) / kChunk;
    const int cap = any_hit ? resident_blocks<true>()
                            : resident_blocks<false>();
    const int blocks = chunks < cap ? chunks : cap;
    const Args a{features, shade, rays8, out_t, out_idx, out_rows, out_occ,
                 valid_count, n, row_from_lane, t_min,
                 (size_t)(n - row_from_lane),
                 !any_hit && valid_count <= kTile && out_rows != nullptr};
    const cudaStream_t s = (cudaStream_t)stream;
    if (any_hit) {
      dense_sweep_kernel<true><<<blocks, kThreads, 0, s>>>(a, tw);
    } else {
      dense_sweep_kernel<false><<<blocks, kThreads, 0, s>>>(a, tw);
    }
  }
  return (int)cudaGetLastError();
}
