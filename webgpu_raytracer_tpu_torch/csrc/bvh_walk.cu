// The two-level skip-pointer BVH walk: closest hit, or any hit, per ray.
//
// wrt_bvh_walk replaces webgpu_raytracer_tpu/ops/intersect.py::_traverse
// (the lax.while_loop at :222), which is XLA in the JAX package, not
// Pallas. There every lane advances in lock step through one masked loop
// whose condition is jnp.any(alive) over all lanes; in eager PyTorch each
// step of that loop would cost a host sync and a dozen launches. On an
// H100 one thread walks one ray to its end.
//
// What it computes, over the merged TLAS+BLAS node array of
// render/resources.py (skips absolutized): a lane starts at node 0 (an
// inactive lane at tlas_end and does nothing). A node is a slab test and
// a cursor assignment: cursor + 1 on a hit inner node, the node's skip on
// a miss or a leaf. A hit TLAS leaf enters its instance (inst = data >> 3):
// the ray is taken into instance space by inst_inv, unnormalized, so t
// compares across spaces; the BLAS walk runs from inst_blas[inst] to that
// root's skip, then the TLAS walk resumes. A hit BLAS leaf tests its
// count = data & 7 (at most 4) triangles first + k in order. The closest
// walk prunes boxes by the best t so far and keeps a hit on strict
// t < best_t (the first in walk order wins a tie); the any-hit walk prunes
// by the lane's t_max and stops at the first occluder. Every lane ends
// within 4 N + 64 steps, the reference's bound.
//
// Bit equality with the plain walk (ops/intersect.py::traverse_plain):
// every operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __frcp_rn: nvcc would otherwise contract products and sums into FMAs),
// the sums of three and the instance transform run left to right as the
// plain version writes them, safe_inv is 1 / (|d| < 1e-20 ? 1e-20 : d),
// and min / max give NaN when either side is NaN, as torch.minimum and
// torch.maximum do (fminf / fmaxf would drop it). A lane's walk order is
// the lock-step walk's, so (t, tri, inst), the occluded flag and the
// optional per-lane counts of nodes visited and triangles tested equal the
// plain version's.
//
// What bounds it on the card: neither bytes nor arithmetic at the rate the
// bound assumes, but latency. Each step is a dependent chain: the node's
// load (32 bytes from four arrays), the slab test, the cursor. A walk of a
// `spheres` ray visits a few hundred nodes down one deep BLAS, and the
// lanes of a warp diverge as soon as their rays part. The design does the
// simplest right thing: the ray and the walk state live in registers, the
// loads go through the read-only path (__ldg), 128 threads a block give
// the scheduler warps to switch between. Node packing, ordered traversal
// and warp compaction are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int clip_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// torch.minimum / torch.maximum: NaN if either side is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct V {
  float x, y, z;
};

__device__ __forceinline__ V load3(const float* __restrict__ p, int i) {
  return V{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

__device__ __forceinline__ V sub(V a, V b) {
  return V{__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

__device__ __forceinline__ float dot(V a, V b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ V cross(V a, V b) {
  return V{__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
           __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
           __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

__device__ __forceinline__ float safe_inv(float d) {
  return __frcp_rn(fabsf(d) < 1e-20f ? 1e-20f : d);
}

__device__ __forceinline__ V safe_inv3(V d) {
  return V{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
}

// Slab test of one box against (o, inv), over (t_min, limit].
__device__ __forceinline__ bool aabb_hit(V lo, V hi, V o, V inv, float t_min,
                                         float limit) {
  const float ax = __fmul_rn(__fsub_rn(lo.x, o.x), inv.x);
  const float ay = __fmul_rn(__fsub_rn(lo.y, o.y), inv.y);
  const float az = __fmul_rn(__fsub_rn(lo.z, o.z), inv.z);
  const float bx = __fmul_rn(__fsub_rn(hi.x, o.x), inv.x);
  const float by = __fmul_rn(__fsub_rn(hi.y, o.y), inv.y);
  const float bz = __fmul_rn(__fsub_rn(hi.z, o.z), inv.z);
  float tn = max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)),
                     min_nan(az, bz));
  float tf = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)),
                     max_nan(az, bz));
  tn = max_nan(tn, t_min);
  tf = min_nan(tf, limit);
  return tn <= tf;
}

// Moller-Trumbore: true and *t on a hit inside (t_min, limit).
__device__ __forceinline__ bool tri_hit(V o, V d, V p0, V p1, V p2,
                                        float t_min, float limit, float* t) {
  const V e1 = sub(p1, p0);
  const V e2 = sub(p2, p0);
  const V h = cross(d, e2);
  const float a = dot(e1, h);
  const bool ok = fabsf(a) >= 1e-6f;
  const float f = __frcp_rn(ok ? a : 1.0f);
  const V s = sub(o, p0);
  const float u = __fmul_rn(f, dot(s, h));
  const V q = cross(s, e1);
  const float v = __fmul_rn(f, dot(d, q));
  *t = __fmul_rn(f, dot(e2, q));
  return ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
         __fadd_rn(u, v) <= 1.0f && *t > t_min && *t < limit;
}

struct Scene {
  const float* node_min;
  const float* node_max;
  const int* node_skip;
  const int* node_data;
  int n_nodes;
  int tlas_end;
  const int* tri_v;
  int n_tris;
  const float* pos;
  const float* inst_inv;
  const int* inst_blas;
  int n_inst;
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(Scene sc, const float* __restrict__ ro,
                const float* __restrict__ rd,
                const float* __restrict__ tmax_lane, float tmax_all,
                float t_min, const unsigned char* __restrict__ active, int r,
                int max_iters, float* __restrict__ out_t,
                int* __restrict__ out_tri, int* __restrict__ out_inst,
                unsigned char* __restrict__ out_occ,
                int* __restrict__ stat_nodes, int* __restrict__ stat_tris) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= r) return;
  const V o = load3(ro, lane);
  const V d = load3(rd, lane);
  const V inv = safe_inv3(d);
  const float t_max = tmax_lane ? __ldg(tmax_lane + lane) : tmax_all;
  const bool live = active ? __ldg(active + lane) != 0 : true;

  int tcur = live ? 0 : sc.tlas_end;
  bool in_blas = false;
  int bcur = 0, bend = 0, cur_inst = 0;
  V lo = o, ld = d, li = inv;
  float best_t = t_max;
  int best_tri = -1, best_inst = -1;
  bool occluded = false;
  int nodes = 0, tris = 0;

  for (int it = 0; it < max_iters; ++it) {
    if (!in_blas && tcur >= sc.tlas_end) break;
    ++nodes;
    const int c = clip_index(in_blas ? bcur : tcur, sc.n_nodes);
    const V nmin = load3(sc.node_min, c);
    const V nmax = load3(sc.node_max, c);
    const int skip = __ldg(sc.node_skip + c);
    const int data = __ldg(sc.node_data + c);
    const bool leaf = data != 0;
    const float limit = kAnyHit ? t_max : best_t;
    const bool hit = in_blas ? aabb_hit(nmin, nmax, lo, li, t_min, limit)
                             : aabb_hit(nmin, nmax, o, inv, t_min, limit);
    if (!in_blas) {
      if (hit && leaf) {  // enter the instance's BLAS
        const int inst = data >> 3;
        const float* m = sc.inst_inv + 16 * clip_index(inst, sc.n_inst);
        const V r0{__ldg(m + 0), __ldg(m + 1), __ldg(m + 2)};
        const V r1{__ldg(m + 4), __ldg(m + 5), __ldg(m + 6)};
        const V r2{__ldg(m + 8), __ldg(m + 9), __ldg(m + 10)};
        lo = V{__fadd_rn(dot(r0, o), __ldg(m + 3)),
               __fadd_rn(dot(r1, o), __ldg(m + 7)),
               __fadd_rn(dot(r2, o), __ldg(m + 11))};
        ld = V{dot(r0, d), dot(r1, d), dot(r2, d)};
        li = safe_inv3(ld);
        const int bstart = __ldg(sc.inst_blas + clip_index(inst, sc.n_inst));
        bend = __ldg(sc.node_skip + clip_index(bstart, sc.n_nodes));
        bcur = bstart;
        cur_inst = inst;
        in_blas = true;
      }
      tcur = (hit && !leaf) ? tcur + 1 : skip;
    } else {
      if (hit && leaf) {
        const int first = data >> 3;
        const int count = min(data & 7, 4);
        tris += count;
        for (int k = 0; k < count; ++k) {
          const int tri = first + k;
          const int* tv = sc.tri_v + 3 * clip_index(tri, sc.n_tris);
          const V p0 = load3(sc.pos, __ldg(tv));
          const V p1 = load3(sc.pos, __ldg(tv + 1));
          const V p2 = load3(sc.pos, __ldg(tv + 2));
          float t;
          if (tri_hit(lo, ld, p0, p1, p2, t_min, kAnyHit ? t_max : best_t,
                      &t)) {
            if (kAnyHit) {
              occluded = true;
            } else {
              best_t = t;
              best_tri = tri;
              best_inst = cur_inst;
            }
          }
        }
      }
      bcur = (hit && !leaf) ? bcur + 1 : skip;
      if (bcur >= bend) in_blas = false;
    }
    if (kAnyHit && occluded) break;  // the lane's walk is over
  }

  if (kAnyHit) {
    out_occ[lane] = occluded ? 1 : 0;
  } else {
    out_t[lane] = best_t;
    out_tri[lane] = best_tri;
    out_inst[lane] = best_inst;
  }
  if (stat_nodes) {
    stat_nodes[lane] = nodes;
    stat_tris[lane] = tris;
  }
}

}  // namespace

// One walk of r rays (ro, rd: (r, 3) f32) over the merged node array.
// tmax_lane (r,) f32 or null for tmax_all; active (r,) bool or null for all.
// any_hit != 0 writes out_occ (r,) bool; else out_t, out_tri, out_inst (r,).
// stat_nodes / stat_tris (r,) i32, both or neither. r >= 1.
extern "C" int wrt_bvh_walk(
    const float* node_min, const float* node_max, const int* node_skip,
    const int* node_data, int n_nodes, int tlas_end, const int* tri_v,
    int n_tris, const float* pos, const float* inst_inv,
    const int* inst_blas, int n_inst, const float* ro, const float* rd,
    const float* tmax_lane, float tmax_all, float t_min,
    const unsigned char* active, int r, int any_hit, float* out_t,
    int* out_tri, int* out_inst, unsigned char* out_occ, int* stat_nodes,
    int* stat_tris, cudaStream_t stream) {
  const Scene sc{node_min, node_max, node_skip, node_data, n_nodes,
                 tlas_end, tri_v,    n_tris,    pos,       inst_inv,
                 inst_blas, n_inst};
  const int max_iters = 4 * n_nodes + 64;
  const int blocks = (r + kThreads - 1) / kThreads;
  if (any_hit) {
    bvh_walk_kernel<true><<<blocks, kThreads, 0, stream>>>(
        sc, ro, rd, tmax_lane, tmax_all, t_min, active, r, max_iters, out_t,
        out_tri, out_inst, out_occ, stat_nodes, stat_tris);
  } else {
    bvh_walk_kernel<false><<<blocks, kThreads, 0, stream>>>(
        sc, ro, rd, tmax_lane, tmax_all, t_min, active, r, max_iters, out_t,
        out_tri, out_inst, out_occ, stat_nodes, stat_tris);
  }
  return static_cast<int>(cudaGetLastError());
}
