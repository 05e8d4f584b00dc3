// The per-triangle ray test shared by dense_sweep.cu, job_sweep.cu and
// scan_sweep.cu, so the three kernels run the same arithmetic on a
// 128-triangle tile of the f32 features table staged in shared memory; the
// segment-sphere test shared by cluster_cull.cu, job_sweep.cu and
// scan_sweep.cu; and the tile step of the two narrow-phase kernels
// (job_sweep.cu, scan_sweep.cu): asynchronous staging, the queue of the
// lanes that touch a tile, and the warp-cooperative walk.
//
// features (16, 5*tw) f32, column groups [s0 | s1 | s2 | tn | td]. Per
// triangle: s_k = f . [d, o x d] (k = 0, 1, 2), tn = f . [o, 1], td = f . d
// (the table's fifth group, the CPU reference's choice, ops/dense.py), each
// dot product summed left to right with separately rounded f32 operations
// (__fmul_rn / __fadd_rn block FMA contraction). The plain PyTorch version
// (webgpu_raytracer_tpu_torch/ops/dense.py::_chunk_t) evaluates the same
// expression, so kernels and plain versions agree bit for bit. Inside test
// inclusive, |td| >= 1e-6, strict t_min < t < t_max. The port's one tie
// rule: the least t wins, and among equal t the lowest triangle index.
//
// Two walks of a staged tile evaluate that one expression:
// - walk_tile: one thread per ray walks the 128 triangles in sequence, every
//   shared-memory read a warp-wide broadcast. Right where every lane of a
//   warp needs the tile (dense_sweep.cu: one tile after another, all lanes
//   live).
// - coop_walk: one warp per (ray, tile) pair; thread w tests triangles 4w
//   to 4w + 3 (one 16-byte load a staged row, consecutive across the warp,
//   no bank conflict) and two __reduce_min_sync pick the winner by the tie
//   rule: first over the bits of t (every candidate t exceeds t_min >= 0,
//   so its f32 pattern orders as an unsigned integer; a miss is
//   0xFFFFFFFF), then over the index among the threads that hold that t.
//   The result does not depend on which thread saw which triangle. Right behind a cull, where
//   few lanes of a warp touch a given tile: in the narrow phase of spheres
//   512^2 a lane's own segment touches 8% (job groups) or 3% (scan tiles)
//   of the (lane, tile) pairs its block's worklist offers, so a thread per
//   ray spends a 128-triangle walk of the whole warp on ~2.5 useful lanes.
//   On an NVIDIA H100 80GB HBM3 at 700 W the change from walk_tile to
//   coop_walk behind the queue took that sweep from 13.8 to 1.74 ms in
//   job_sweep.cu and from 24.7 to 2.90 ms in scan_sweep.cu, bit for bit
//   the same results (2.21 and 3.11 ms with a thread taking triangles w,
//   w + 32, w + 64, w + 96 in four scalar, branching passes).
//
// The tile step around coop_walk (WalkScratch): the touching lanes append
// themselves to a queue in shared memory (queue_push: one ballot and one
// atomicAdd a warp), the block's warps take the queue's entries in turn
// (walk_queue) and hand (t bits, index) back to the owning lane through
// shared memory; the owner commits after the barrier that ends the tile.
// Tiles are staged two deep with cp.async (stage_tile_async): the next
// worklist entry's 12.8 KB load while this one is walked.

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

// Walk a staged tile of cnt triangles (global indices base + j), one thread
// per ray. Closest mode lowers (best_t, best_i) on strict < in ascending
// index order, so the lowest index wins an exact tie; any-hit mode sets occ
// at the first hit inside (t_min, t_max) and stops.
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
    } else if (t < best_t) {
      best_t = t;
      best_i = base + j;
    }
  }
}

constexpr unsigned kMiss = 0xffffffffu;  // t bits of "no hit in this tile"

// One side or denominator term of four neighbouring triangles at once:
// walk_tile's left-to-right sum, operation for operation, on the float4
// that thread-contiguous triangles share.
__device__ __forceinline__ void dot4(const float* coef, int n,
                                     float (*tri)[kTile], int q, int j0,
                                     float* out) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(&tri[q + k][j0]);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      out[m] = k == 0 ? mul(coef[0], f[m]) : add(out[m], mul(coef[k], f[m]));
    }
  }
}

// Walk a staged tile of cnt triangles for one ray with the whole warp:
// every thread returns the bits of the least t > t_min in the tile (kMiss
// when nothing is hit) and the tile-local index of the lowest triangle
// that has it. All 32 threads call it together with the same ray; t_min
// must not be negative (see the header). Thread w takes triangles 4w to
// 4w + 3, so each staged row is one 16-byte shared-memory load a thread,
// and the sixteen sums (three sides and the denominator of four triangles)
// are independent chains that keep the warp issuing; numerator and
// quotient are taken only by a thread that holds a candidate. Each
// triangle's value is walk_tile's, operation for operation.
__device__ __forceinline__ void coop_walk(float (*tri)[kTile], int cnt,
                                          const Ray& r, float t_min,
                                          unsigned& t_bits, int& j_win) {
  const int j0 = 4 * (threadIdx.x & 31);
  const float dm[6] = {r.dx, r.dy, r.dz, r.mx, r.my, r.mz};
  float s0[4], s1[4], s2[4], td[4];
  dot4(dm, 6, tri, 0, j0, s0);
  dot4(dm, 6, tri, 6, j0, s1);
  dot4(dm, 6, tri, 12, j0, s2);
  dot4(dm, 3, tri, 22, j0, td);
  bool cand[4];
  for (int m = 0; m < 4; ++m) {
    const bool inside = fminf(fminf(s0[m], s1[m]), s2[m]) >= 0.f ||
                        fmaxf(fmaxf(s0[m], s1[m]), s2[m]) <= 0.f;
    cand[m] = j0 + m < cnt && inside && fabsf(td[m]) >= 1e-6f;
  }
  unsigned bits = kMiss;
  unsigned jb = kTile;
  if (cand[0] || cand[1] || cand[2] || cand[3]) {
    const float o[3] = {r.ox, r.oy, r.oz};
    float tn[4];
    dot4(o, 3, tri, 18, j0, tn);
    const float4 v = *reinterpret_cast<const float4*>(&tri[21][j0]);
    const float w[4] = {v.x, v.y, v.z, v.w};
    for (int m = 0; m < 4; ++m) {
      const float t = __fdiv_rn(add(tn[m], w[m]), td[m]);
      if (cand[m] && t > t_min && __float_as_uint(t) < bits) {
        bits = __float_as_uint(t);
        jb = j0 + m;
      }
    }
  }
  t_bits = __reduce_min_sync(0xffffffffu, bits);
  j_win = (int)__reduce_min_sync(0xffffffffu, bits == t_bits ? jb : kTile);
}

// Shared memory of the narrow-phase kernels' tile step, for a block of B
// threads (a multiple of 32): carved from dynamic shared memory, which
// passes the 48 KB of static shared memory at B = 1024.
struct WalkScratch {
  float (*tri)[kFeat][kTile];  // two staged tiles, entry k in tri[k & 1]
  float* ray;             // (7, B) the block's rays [d, o, t_max]
  unsigned* res_t;        // (B,) a queued lane's t bits in this tile
  int* res_i;             // (B,) and the winner's global index
  int* count;             // (3,) queue lengths, entry k in count[k % 3]
  int* row_off;           // (25,) feat_offset(q, tw) of the staged rows
  unsigned short* queue;  // (B,) the threads whose lane touches the tile
};

__host__ __device__ inline size_t walk_scratch_bytes(int B) {
  return 2 * kFeat * kTile * sizeof(float) + (size_t)B * (7 + 2) * 4 +
         (4 + 28) * sizeof(int) + (size_t)B * sizeof(unsigned short);
}

// p is the block's dynamic shared memory, 16-byte aligned.
__device__ __forceinline__ WalkScratch walk_scratch(unsigned char* p, int B) {
  WalkScratch s;
  s.tri = reinterpret_cast<float(*)[kFeat][kTile]>(p);
  s.ray = reinterpret_cast<float*>(p + 2 * kFeat * kTile * sizeof(float));
  s.res_t = reinterpret_cast<unsigned*>(s.ray + 7 * B);
  s.res_i = reinterpret_cast<int*>(s.res_t + B);
  s.count = s.res_i + B;
  s.row_off = s.count + 4;
  s.queue = reinterpret_cast<unsigned short*>(s.row_off + 28);
  return s;
}

// What a block sets up before its worklist: sorted lane `lane`'s ray
// [d, o, t_max] into r[7] and into the shared ray block, the staged rows'
// offsets in a (16, 5 * tw) features table, the queue lengths zeroed.
// Every thread calls it; it synchronises the block.
__device__ __forceinline__ void walk_begin(const WalkScratch& s,
                                           const float* __restrict__ rays_s,
                                           int rp, int lane, int tw,
                                           float* r) {
  const int B = blockDim.x, tid = threadIdx.x;
  for (int k = 0; k < 7; ++k) {
    r[k] = rays_s[(size_t)k * rp + lane];
    s.ray[k * B + tid] = r[k];
  }
  if (tid < kFeat) s.row_off[tid] = feat_offset(tid, tw);
  if (tid < 3) s.count[tid] = 0;
  __syncthreads();
}

// Start the copy of the 128-triangle tile at `base` into tri[buf]: 25 rows
// of 128 contiguous floats, as 16-byte cp.async copies past L1, every
// thread of the block taking part (the rows' offsets come from the table
// the kernel filled once, not from feat_offset's divisions). The table is
// padded to whole tiles, so a ragged last tile copies its padding too and
// the walk masks it. The caller commits the group; every thread waits for
// its own copies and the block synchronises before the tile is read.
__device__ __forceinline__ void stage_tile_async(const WalkScratch& s, int buf,
                                                 const float* __restrict__
                                                     features,
                                                 int base) {
  constexpr int kVec = kTile / 4;  // 16-byte copies a row
  for (int e = threadIdx.x; e < kFeat * kVec; e += blockDim.x) {
    const int q = e / kVec, c = 4 * (e % kVec);
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(&s.tri[buf][q][c]);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(features + s.row_off[q] + base + c)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until none of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Append this thread to the queue when its lane touches the tile: one
// ballot and one atomicAdd a warp. Every thread of the block calls it; a
// barrier must separate it from the reads of queue and *count. The order
// of the queue varies from run to run and no result depends on it.
__device__ __forceinline__ void queue_push(bool touch, unsigned short* queue,
                                           int* count) {
  const int w = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, touch);
  int start = 0;
  if (w == 0 && ballot != 0) start = atomicAdd(count, __popc(ballot));
  start = __shfl_sync(0xffffffffu, start, 0);
  if (touch) {
    queue[start + __popc(ballot & ((1u << w) - 1u))] =
        (unsigned short)threadIdx.x;
  }
}

// The block's warps take the nq queued lanes in turn (warp k entries k,
// k + W, ...): fetch the lane's ray from the shared ray block (o x d is
// rebuilt by make_ray's own operations, so its bits are the owner's),
// coop_walk the staged tile, and leave the t bits and the winner's global
// index at the owner's slot. The caller synchronises before the owners
// read their slots.
__device__ __forceinline__ void walk_queue(const WalkScratch& s,
                                           float (*tri)[kTile], int cnt,
                                           int base, int nq, float t_min) {
  const int B = blockDim.x;
  for (int e = threadIdx.x >> 5; e < nq; e += B >> 5) {
    const int owner = s.queue[e];
    float r[6];
    for (int k = 0; k < 6; ++k) r[k] = s.ray[k * B + owner];
    unsigned t_bits;
    int j_win;
    coop_walk(tri, cnt, make_ray(r), t_min, t_bits, j_win);
    if ((threadIdx.x & 31) == 0) {
      s.res_t[owner] = t_bits;
      s.res_i[owner] = base + j_win;
    }
  }
}

// Entry k of a block's worklist (tile id `tile`), after the barrier that
// published its queue (queue_push into count[k % 3]), made its staged tile
// visible (every thread waited for its own part of the copy before that
// barrier) and retired entry k - 1: starts the copy of entry k + 1's tile
// (`next_tile`, negative past the end of the list) into the other buffer,
// whose last reader was entry k - 1's walk, and, when some lane queued,
// walks the queue and synchronises, so the owners may read their slots.
// Returns the queue's length, the same in every thread. The caller staged
// entry 0 into tri[0] before the loop, calls cp_async_wait ahead of
// each entry's barrier and once more after the loop.
__device__ __forceinline__ int walk_entry(const WalkScratch& s,
                                          const float* __restrict__ features,
                                          int valid, int k, int tile,
                                          int next_tile, float t_min) {
  const int nq = s.count[k % 3];
  // Entry k + 2's length: last read before the caller's barrier, next
  // added to after its next one.
  if (threadIdx.x == 0) s.count[(k + 2) % 3] = 0;
  if (next_tile >= 0) {
    stage_tile_async(s, (k + 1) & 1, features, next_tile * kTile);
    cp_async_commit();
  }
  if (nq == 0) return 0;
  const int base = tile * kTile;
  walk_queue(s, s.tri[k & 1], max(0, min(kTile, valid - base)), base, nq,
             t_min);
  __syncthreads();
  return nq;
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
