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
// a block of g threads walks one (group, chunk) job at a time, one thread
// owning one sorted lane, each worklisted tile of the f32 features table is
// staged in shared memory, and the lanes that touch it are walked one warp
// to a (lane, tile) pair with tri_tile.cuh, the arithmetic of
// dense_sweep.cu.
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
//   stats   (G, 4) i32   optional [tiles walked, (lane, tile) pairs walked,
//                        worklist length, chunks (ceil(length / L))] per
//                        group; null writes none
//   scratch              wrt_job_sweep_scratch_bytes(rp, g, ct, L) bytes:
//                        the job queue and the split groups' merge slots
//
// Jobs. A worklist of more than L entries (L = chunk_len, ops/tune.py's
// JOB_CHUNK) is cut into chunks of at most L consecutive entries, walked by
// different blocks at the same time; a shorter one is one job, walked as
// before the split. The grid is persistent: the blocks that fit on the card
// at once (fixed by g and the device, never by the counts, so no host sync
// and one launch in a captured graph). A block takes jobs from a cursor in
// the scratch: first (group, chunk 0) for every group in order; the block
// that takes a split group's chunk 0 reads its count, readies the group's
// merge slots and outstanding-chunk counter, and queues its other chunks;
// once every chunk 0 is taken, the cursor runs on into that queue. A block
// that finds the queue empty waits only while some chunk-0 taker has not
// queued yet (each does so right after taking its job, before walking), and
// ends when all have and the queue is drained. The memset ahead of the
// launch zeroes the cursor and the queue; the slots are readied by the
// chunk-0 taker, so each launch starts clean.
//
// Per worklist entry k of a job, in order (tiles in ascending id):
// 1. Each lane tests its own open segment, (t_min, best t so far) or
//    (t_min, t_max) in any-hit mode, against the tile's sphere
//    (tri_tile.cuh::touches, the cull's test) and, if it can touch it,
//    appends itself to the block's queue. One __syncthreads_or ends the
//    job when no lane is live (dead lanes sort to the end of their
//    segment) or, in any-hit mode, all are occluded; the same barrier
//    publishes the queue and the staged tile (each thread waits for its own
//    part of the copy just before it) and retires the previous tile.
// 2. The copy of entry k + 1's tile starts (cp.async into the other of two
//    buffers), to land behind this tile's walk. A tile that no lane touches
//    is not walked and not counted: it costs its copy.
// 3. The block's warps take the queued lanes in turn, one warp walking the
//    tile for one lane (coop_walk), and the owners commit on the least
//    (t, index) after the barrier that ends the tile, so a lane's best t is
//    final before the next tile's test reads it.
//
// The tie rule across chunks. The port's winner is the least t, and among
// equal t the lowest triangle index: the least (t bits, index), as t >
// t_min >= 0 orders its bits as unsigned integers. A chunk of a split group
// starts from the lane's best published so far (a plain read of its 64-bit
// slot; one that is stale only admits more tiles) and commits a tile's
// winner when (t, index) is less than its best; at its end it publishes
// with one atomicMin of (t bits << 32 | index) into the slot (occlusion: a
// byte set to 1). A lane whose best t came from a later chunk still walks a
// tile holding the same t at a lower index: the touch test's end is
// nudged outward (hi_term = dd (t (1 + 1e-6))), so a tile whose sphere the
// segment up to t reaches is never skipped, and that tile's lower index
// then wins the commit and the atomicMin
// (tests/test_torch_jobs.py::test_chunked_walk_cross_chunk_tie holds the
// plain model of this walk to the one-block walk with the chunks in either
// order). A one-chunk group commits the same way, which over ascending
// tiles is dense_sweep.cu's strict < in index order. The last block to end
// a split group's chunk (its outstanding-chunk counter, after a fence)
// reads the slots and writes t, idx, rows and occ as a one-chunk group
// does. So t, idx and rows are bit-equal to dense_sweep.cu walking every
// tile: a lane that cannot touch a tile's sphere inside its segment cannot
// hit inside it, and the per-triangle t are those of dense_sweep.cu. Left
// out, as TPU-only: the bf16x3 operands, the DMA queue and its short-drain
// zeroing, the t / idx mirror rows, the one-hot row matmul and the
// row-major un-permute gather.
//
// What bounds it on an H100: instruction issue over the (lane, tile) pairs
// walked, ~300 warp-instructions a pair (4 triangles a thread: 25 16-byte
// shared-memory loads, ~180 separately rounded f32 operations, the tests,
// the ray fetch and two reductions), plus ~60 instructions a lane and two
// barriers a walked tile for the test, the queue and the commit. Bytes are
// small beside it (32 B of ray in and 168 B out a lane, 12.8 KB of
// triangles per (group, tile), mostly from L2, loaded behind the previous
// tile's walk). The design spends the walk only where it is needed: on the
// fused bounce-1 sweep of spheres 512^2 a group's worklist offers each
// lane 215 tiles and the lane's segment touches 8% of them, so the walk by
// one thread per ray that this kernel replaced spent a 128-triangle walk
// of a whole warp on ~2.5 useful lanes.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, on that sweep (524,288
// lanes, 127,524 live; 997 non-empty groups, 214,082 (group, tile) jobs),
// before the split: 1.74 ms (any-hit 1.36 ms) where the walk by one thread
// per ray took 13.8 ms, against a bound of 0.18 ms; 2,299,142 pairs walked,
// 2,096,545 needed. ~0.8 G warp-instructions would take ~0.9 ms spread
// evenly over the SMs, but one block walked a worklist in sequence, and the
// longest (732 tiles, 3.4x the mean) took 1.09 ms alone on its SM: the
// launch was set by its tail. Split into chunks of 64: 1.37 ms (any-hit
// 1.10). On the eleven job sweeps of a spheres 720x480 d10 frame the split
// took 15.67 ms to 10.91 at L = 16 (11.46 at 64; the primary sweep, 2,700
// groups of median length 43 and no tail to cut, stays at 4.1-4.2 ms), for
// 3.8% more pairs walked. 64 registers, 8 bytes of spill; 30.6 KB of
// shared memory a 128-thread block, so 7 blocks an SM, 924 on the card.
// PERF.md §6 has the times of every sweep.

#include <cuda_runtime.h>

#include <climits>
#include <mutex>

#include "tri_tile.cuh"

namespace {

using namespace wrt;

// The scratch's int32 words: a header of three counters, each on a
// 128-byte line of its own, then the queue of extra chunks, then each
// group's outstanding chunks. The header and the queue are zeroed before
// every launch.
constexpr int kCursor = 0;       // jobs handed out
constexpr int kQueued = 32;      // chunk-0 jobs whose extra chunks are queued
constexpr int kTail = 64;        // queue entries reserved
constexpr int kHeaderWords = 96;
constexpr unsigned long long kNoHit = ~0ull;  // an empty merge slot

struct JobScratch {
  int* words;                // the header
  int* queue;                // group * max_chunks + chunk + 1; 0 unwritten
  int* left;                 // (G,) a split group's chunks not yet ended
  unsigned long long* best;  // (rp,) a split group's lanes: (t bits, idx)
  unsigned char* occ;        // (rp,) a split group's lanes: occluded
};

struct ScratchLayout {
  size_t zeroed, left, best, occ, bytes;
};

__host__ __device__ inline ScratchLayout scratch_layout(int rp, int g,
                                                        int max_chunks) {
  const size_t G = (size_t)(rp / g);
  ScratchLayout l;
  l.zeroed = (kHeaderWords + G * (size_t)(max_chunks - 1)) * sizeof(int);
  l.left = l.zeroed;
  l.best = (l.left + G * sizeof(int) + 15) / 16 * 16;
  l.occ = l.best + (size_t)rp * sizeof(unsigned long long);
  l.bytes = l.occ + (size_t)rp;
  return l;
}

__device__ __forceinline__ JobScratch job_scratch(unsigned char* p, int rp,
                                                  int g, int max_chunks) {
  const ScratchLayout l = scratch_layout(rp, g, max_chunks);
  JobScratch s;
  s.words = reinterpret_cast<int*>(p);
  s.queue = s.words + kHeaderWords;
  s.left = reinterpret_cast<int*>(p + l.left);
  s.best = reinterpret_cast<unsigned long long*>(p + l.best);
  s.occ = p + l.occ;
  return s;
}

// Waits of more than ~2^26 sleeps (seconds) trap: a fault, never a hang.
constexpr unsigned kMaxSleeps = 1u << 26;

__device__ __forceinline__ void sleep_once(unsigned& sleeps) {
  if (++sleeps > kMaxSleeps) __trap();
  __nanosleep(64);
}

// The next (group, chunk) job, (-1, 0) when none is left. Thread 0 calls
// it. Cursor values below G are the groups' chunk-0 jobs; the rest index
// the queue. An index past the reserved entries waits while some chunk-0
// taker has not queued its extras (that taker is running: it queues right
// after it takes its job), and ends once all have.
__device__ int2 take_job(const JobScratch& js, int G, int max_chunks) {
  const int j = atomicAdd(&js.words[kCursor], 1);
  if (j < G) return make_int2(j, 0);
  const int k = j - G;
  volatile int* words = js.words;
  volatile int* queue = js.queue;
  unsigned sleeps = 0;
  for (;;) {
    if (k < words[kTail]) {
      int e;
      while ((e = queue[k]) == 0) sleep_once(sleeps);
      __threadfence();  // the group's slots and counter before its entry
      --e;
      return make_int2(e / max_chunks, e % max_chunks);
    }
    if (words[kQueued] == G) {
      __threadfence();  // every reservation before the count that saw it
      if (k < words[kTail]) continue;
      return make_int2(-1, 0);
    }
    sleep_once(sleeps);
  }
}

// After the block readied a split group's slots: its counter and stats,
// then its chunks 1 .. chunks - 1 into the queue. Thread 0 calls it for
// every chunk-0 job, split or not.
__device__ void queue_chunks(const JobScratch& js, int* stats, int group,
                             int count, int chunks, int max_chunks) {
  if (chunks > 1) {
    js.left[group] = chunks;
    if (stats != nullptr) {
      stats[4 * group] = 0;
      stats[4 * group + 1] = 0;
      stats[4 * group + 2] = count;
      stats[4 * group + 3] = chunks;
    }
    __threadfence();
    const int base = atomicAdd(&js.words[kTail], chunks - 1);
    volatile int* queue = js.queue;
    for (int c = 1; c < chunks; ++c) {
      queue[base + c - 1] = group * max_chunks + c + 1;
    }
    __threadfence();
  }
  atomicAdd(&js.words[kQueued], 1);
}

// One lane's results at its caller position.
__device__ __forceinline__ void write_lane(int p, int n_out, int any_hit,
                                           bool occ, float best_t,
                                           int best_i, int row_from,
                                           const float* __restrict__ shade,
                                           float* __restrict__ out_t,
                                           int* __restrict__ out_idx,
                                           float* __restrict__ out_rows,
                                           unsigned char* __restrict__
                                               out_occ) {
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
                 int* __restrict__ stats, int chunk_len, int max_chunks,
                 unsigned char* __restrict__ scratch_g) {
  extern __shared__ __align__(16) unsigned char scratch[];
  __shared__ int2 job;
  __shared__ int last;
  const int B = blockDim.x, tid = threadIdx.x;
  const int G = rp / B;
  const WalkScratch s = walk_scratch(scratch, B);
  const JobScratch js = job_scratch(scratch_g, rp, B, max_chunks);

  for (;;) {
    if (tid == 0) job = take_job(js, G, max_chunks);
    __syncthreads();
    const int group = job.x, chunk = job.y;
    if (group < 0) break;
    const int count = counts[group];
    const int chunks = max(1, (count + chunk_len - 1) / chunk_len);
    const bool split = chunks > 1;
    const int lane = group * B + tid;  // < rp
    if (split && chunk == 0) {
      if (any_hit) {
        js.occ[lane] = 0;
      } else {
        js.best[lane] = kNoHit;
      }
      __threadfence();
    }
    float r[7];
    walk_begin(s, rays_s, rp, lane, tw, r);  // also orders the slots
    if (tid == 0 && chunk == 0) {
      queue_chunks(js, stats, group, count, chunks, max_chunks);
    }
    const Ray ray = make_ray(r);
    const float t_max = r[6];
    float best_t = t_max;
    int best_i = -1;
    bool occ = false;
    if (split) {
      if (any_hit) {
        occ = reinterpret_cast<volatile unsigned char*>(js.occ)[lane] != 0;
      } else {
        const unsigned long long key =
            reinterpret_cast<volatile unsigned long long*>(js.best)[lane];
        if (key != kNoHit) {
          best_t = __uint_as_float((unsigned)(key >> 32));
          best_i = (int)(unsigned)key;
        }
      }
    }
    const bool active = t_max > 0.f;
    const float dd = add(add(mul(ray.dx, ray.dx), mul(ray.dy, ray.dy)),
                         mul(ray.dz, ray.dz));
    const float lo_term = mul(dd, a_lo_k);

    const int k0 = chunk * chunk_len;
    const int k1 = min(count, k0 + chunk_len);
    const int* list = order + (size_t)group * ct;
    if (k0 < k1) stage_tile_async(s, k0 & 1, features, list[k0] * kTile);
    cp_async_commit();
    int walked = 0, pairs = 0;
    for (int k = k0; k < k1; ++k) {
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
                                k + 1 < k1 ? list[k + 1] : -1, t_min);
      if (nq == 0) continue;
      ++walked;
      pairs += nq;
      if (!touch) continue;
      const unsigned t_bits = s.res_t[tid];
      const float t = __uint_as_float(t_bits);
      if (t_bits == kMiss) continue;
      const int idx = s.res_i[tid];
      if (any_hit) {
        occ = t < t_max;
      } else if (t < best_t || (t == best_t && idx < best_i)) {
        best_t = t;
        best_i = idx;
      }
    }
    cp_async_wait();

    const int p = perm[lane];
    if (!split) {
      if (stats != nullptr && tid == 0) {
        stats[4 * group] = walked;
        stats[4 * group + 1] = pairs;
        stats[4 * group + 2] = count;
        stats[4 * group + 3] = (count + chunk_len - 1) / chunk_len;
      }
      write_lane(p, n_out, any_hit, occ, best_t, best_i, row_from, shade,
                 out_t, out_idx, out_rows, out_occ);
    } else {
      if (any_hit) {
        if (occ) js.occ[lane] = 1;
      } else if (best_i >= 0) {
        atomicMin(&js.best[lane],
                  (unsigned long long)__float_as_uint(best_t) << 32 |
                      (unsigned)best_i);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        if (stats != nullptr) {
          atomicAdd(&stats[4 * group], walked);
          atomicAdd(&stats[4 * group + 1], pairs);
        }
        last = atomicSub(&js.left[group], 1) == 1;
      }
      __syncthreads();
      if (last) {  // every chunk of the group has published
        __threadfence();
        if (any_hit) {
          occ = reinterpret_cast<volatile unsigned char*>(js.occ)[lane] != 0;
        } else {
          const unsigned long long key =
              reinterpret_cast<volatile unsigned long long*>(js.best)[lane];
          best_t = key == kNoHit ? t_max : __uint_as_float(
                                               (unsigned)(key >> 32));
          best_i = key == kNoHit ? -1 : (int)(unsigned)key;
        }
        write_lane(p, n_out, any_hit, occ, best_t, best_i, row_from, shade,
                   out_t, out_idx, out_rows, out_occ);
      }
    }
    // The next job rewrites `job`, `last` and the block's shared memory.
    __syncthreads();
  }
}

// Blocks of g threads that fit on the current device at once.
int resident_blocks(int g, size_t smem) {
  static std::mutex mu;
  static int known_dev = -1, known_g = 0, known_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev == known_dev && g == known_g) return known_blocks;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, job_sweep_kernel, g, smem);
  }
  if (err != cudaSuccess) return -(int)err;
  known_dev = dev;
  known_g = g;
  known_blocks = sms * max(per_sm, 1);
  return known_blocks;
}

int max_chunks_of(int ct, int chunk_len) {
  return (ct + chunk_len - 1) / chunk_len;
}

}  // namespace

// Bytes of scratch wrt_job_sweep needs for rp lanes in groups of g, ct
// tiles and chunks of chunk_len worklist entries.
extern "C" size_t wrt_job_sweep_scratch_bytes(int rp, int g, int ct,
                                              int chunk_len) {
  if (rp <= 0 || g <= 0 || ct <= 0 || chunk_len <= 0) return 0;
  return scratch_layout(rp, g, max_chunks_of(ct, chunk_len)).bytes;
}

// Returns the first CUDA error of the launch (0 on success). g threads a
// block (a multiple of 32, at most 1024; rp = G * g), as many blocks as fit
// on the card at once. any_hit != 0 writes out_occ only; otherwise out_t /
// out_idx, and out_rows when it is not null. stats may be null. t_min must
// not be negative, features 16-byte aligned and tw a multiple of 4;
// scratch holds wrt_job_sweep_scratch_bytes(rp, g, ct, chunk_len) bytes,
// 16-byte aligned, and is zeroed in part here (one memset on the stream).
extern "C" int wrt_job_sweep(const float* features, int tw, int valid_count,
                             const float* shade, const float* rays_s, int rp,
                             int g, const int* perm, int n_out,
                             const int* order, const int* counts,
                             const float* spheres, int ct, float t_min,
                             float a_lo_scale, float hi_nudge, int any_hit,
                             int row_from_lane, float* out_t, int* out_idx,
                             float* out_rows, unsigned char* out_occ,
                             int* stats, int chunk_len, void* scratch,
                             void* stream) {
  if (rp <= 0) return 0;
  const int max_chunks = ct > 0 && chunk_len > 0
                             ? max_chunks_of(ct, chunk_len) : 0;
  if (!(t_min >= 0.f) || tw % 4 != 0 || max_chunks <= 0 ||
      (long long)(rp / g) * max_chunks >= INT_MAX ||
      reinterpret_cast<size_t>(features) % 16 != 0 ||
      reinterpret_cast<size_t>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // Past the 48 KB a kernel gets unasked from g = 640.
  const size_t bytes = walk_scratch_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      job_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int resident = resident_blocks(g, bytes);
  if (resident < 0) return -resident;
  const ScratchLayout l = scratch_layout(rp, g, max_chunks);
  err = cudaMemsetAsync(scratch, 0, l.zeroed, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  job_sweep_kernel<<<min(rp / g, resident), g, bytes,
                     (cudaStream_t)stream>>>(
      features, tw, valid_count, shade, rays_s, rp, perm, n_out, order,
      counts, reinterpret_cast<const float4*>(spheres), ct, t_min,
      a_lo_scale, hi_nudge, any_hit, row_from_lane, out_t, out_idx,
      out_rows, out_occ, stats, chunk_len, max_chunks,
      static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}
