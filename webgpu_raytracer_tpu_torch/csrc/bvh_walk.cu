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
// plain version writes them, safe_inv is 1 / (|d| < 1e-20 ? 1e-20 : d).
// A lane's walk order is the lock-step walk's, so (t, tri, inst), the
// occluded flag and the optional per-lane counts of nodes visited and
// triangles tested equal the plain version's.
//
// What bounds it: the latency of each lane's chain of dependent steps (a
// node's load, its slab test, the next cursor), not bytes or arithmetic at
// the rates the bound assumes; a `spheres` walk is 77 nodes on average and
// up to 510. The first version's step was 8 scalar loads from four arrays
// (node_min and node_max at a 12-byte stride, node_skip, node_data; up to
// five 32-byte sectors), a triangle two dependent gathers (tri_v, then three
// pos rows), an instance entry 12 scalar loads, and its slab test 12
// NaN-propagating min / max, each a compare, a select and an fminf. What
// this version does:
//
// 1. Packed records (ops/intersect.py::pack_walk, built once for a
//    DeviceScene: ops/trace.py::scene_packs). A node is 32 bytes, (min.xyz, skip | max.xyz, data), read as
//    two 16-byte loads from one sector. A triangle is 48 bytes, (p0, e1 =
//    p1 - p0, e2 = p2 - p0), three 16-byte loads with no index; e1 and e2
//    are one f32 subtraction each, made by torch exactly as Moller-Trumbore
//    makes them, so the bits are the same. An instance is 64 bytes: rows 0-2
//    of inst_inv, then (BLAS start, BLAS end). Same floats, no new
//    arithmetic.
// 2. The slab test without NaN guards on finite rays. Claim: if a lane's o
//    and d are finite, its t_max and t_min are not NaN and every node bound
//    is finite, no operand of a min / max in the slab test is NaN, so
//    fminf / fmaxf give the values torch.minimum / torch.maximum give, up to
//    the sign of a zero, which tn <= tf cannot see. Proof: inv = 1 / d (or
//    1e20 for |d| < 1e-20) is finite and non-zero (no flush to zero: the
//    library is built without fast math, and 1 / FLT_MAX is a subnormal,
//    not 0); b - o of two finite floats is finite or +-inf; a finite or
//    infinite value times a finite non-zero one is never NaN. limit is t_max
//    or a best t that passed t < limit, never NaN. The same holds for the
//    instance-space ray, checked when the lane enters a BLAS. Node bounds are
//    checked once when the pack is built (WalkPack.finite). A lane or scene
//    that fails a check takes the NaN-propagating test (min_nan / max_nan),
//    as before.
// 3. The world ray is not held in registers for the whole walk: it is
//    reloaded from ro / rd where a lane enters or leaves a BLAS (once each on
//    a one-instance scene), so a thread needs fewer registers and an SM
//    holds more warps.
// 4. One thread a ray, 128 a block, the grid covering the rays, as before: a
//    lane that ends leaves its warp, a warp that ends frees its slot, and the
//    block scheduler refills the SM a block at a time at no cost a step.
//    Measured on the H100 and dropped (PERF.md): persistent warps that refill
//    their finished lanes from a counter (Aila and Laine, "Understanding the
//    Efficiency of Ray Traversal on GPUs", HPG 2009), with or without their
//    while-while loop, were slower on every stack, although the bounce-1
//    rays leave most lanes of a warp idle: the time follows the number of
//    warps walking at once, each waiting on its own chain of loads, more
//    than the lanes each keeps busy.
//
// Left as it is: the walk order. Ordered (front-to-back, stack-based)
// traversal would change the tie rule and the per-lane counts.

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

__device__ __forceinline__ V xyz(float4 a) { return V{a.x, a.y, a.z}; }

__device__ __forceinline__ V xyz_bits(int4 a) {
  return V{__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z)};
}

// Finite: neither NaN (which fails every comparison) nor +-inf.
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

__device__ __forceinline__ bool finite3(V v) {
  return finite(v.x) && finite(v.y) && finite(v.z);
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

// Slab test of one box against (o, inv), over (t_min, limit]. exact: the
// NaN-propagating min / max of the plain walk; else fminf / fmaxf, which
// give the same answer where no operand is NaN (the header's claim 2).
__device__ __forceinline__ bool aabb_hit(V lo, V hi, V o, V inv, float t_min,
                                         float limit, bool exact) {
  const float ax = __fmul_rn(__fsub_rn(lo.x, o.x), inv.x);
  const float ay = __fmul_rn(__fsub_rn(lo.y, o.y), inv.y);
  const float az = __fmul_rn(__fsub_rn(lo.z, o.z), inv.z);
  const float bx = __fmul_rn(__fsub_rn(hi.x, o.x), inv.x);
  const float by = __fmul_rn(__fsub_rn(hi.y, o.y), inv.y);
  const float bz = __fmul_rn(__fsub_rn(hi.z, o.z), inv.z);
  if (exact) {
    float tn = max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)),
                       min_nan(az, bz));
    float tf = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)),
                       max_nan(az, bz));
    tn = max_nan(tn, t_min);
    tf = min_nan(tf, limit);
    return tn <= tf;
  }
  const float tn = fmaxf(
      fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz)), t_min);
  const float tf = fminf(
      fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz)), limit);
  return tn <= tf;
}

// Moller-Trumbore on (p0, e1, e2): true and *t on a hit inside
// (t_min, limit).
__device__ __forceinline__ bool tri_hit(V o, V d, V p0, V e1, V e2,
                                        float t_min, float limit, float* t) {
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

struct Pack {
  const int4* nodes;    // (n_nodes, 2): (min.xyz, skip), (max.xyz, data)
  int n_nodes;
  int tlas_end;
  const float4* tris;   // (n_tris, 3): (p0, 0), (e1, 0), (e2, 0)
  int n_tris;
  const float4* insts;  // (n_inst, 4): inst_inv rows 0-2, (start, end, 0, 0)
  int n_inst;
  const int* finite;    // 1 when every node bound is finite
};

struct Rays {
  const float* ro;         // (r, 3)
  const float* rd;         // (r, 3)
  const float* tmax_lane;  // (r,) or null for tmax_all
  float tmax_all;
  float t_min;
  const unsigned char* active;  // (r,) or null for all
  int r;
  int max_iters;
};

struct Out {
  float* t;
  int* tri;
  int* inst;
  unsigned char* occ;
  int* nodes;  // with the triangle counts, or null
  int* tris;
};

// One lane's walk: its ray in world space and in the current space (the
// world's, or an instance's inside a BLAS), its cursors and its results.
struct Walk {
  int ray;       // the world ray is reloaded from ro / rd where needed
  V co, cd, ci;  // the current space's origin, direction, 1 / direction
  bool exact_w, exact_c;  // the NaN-propagating slab test, world / current
  float t_max, best_t;
  int best_tri, best_inst, cur_inst;
  int tcur, bcur, bend, nodes, tris;
  bool in_blas, occluded;
};

__device__ __forceinline__ void start(Walk& w, const Pack& sc,
                                      const Rays& in, int ray,
                                      bool scene_exact) {
  w.ray = ray;
  const V o = load3(in.ro, ray);
  const V d = load3(in.rd, ray);
  const V inv = safe_inv3(d);
  w.t_max = in.tmax_lane ? __ldg(in.tmax_lane + ray) : in.tmax_all;
  const bool live = in.active ? __ldg(in.active + ray) != 0 : true;
  w.tcur = live ? 0 : sc.tlas_end;
  w.in_blas = false;
  w.best_t = w.t_max;
  w.best_tri = w.best_inst = -1;
  w.occluded = false;
  w.nodes = w.tris = 0;
  w.co = o;
  w.ci = inv;
  w.exact_w = scene_exact ||
              !(finite3(o) && finite3(d) && w.t_max == w.t_max);
  w.exact_c = w.exact_w;
}

__device__ __forceinline__ bool walk_done(const Walk& w, const Pack& sc,
                                          const Rays& in, bool any_hit) {
  return (!w.in_blas && w.tcur >= sc.tlas_end) || w.nodes >= in.max_iters ||
         (any_hit && w.occluded);
}

__device__ __forceinline__ void leave_blas(Walk& w, const Rays& in) {
  w.in_blas = false;
  w.co = load3(in.ro, w.ray);
  w.ci = safe_inv3(load3(in.rd, w.ray));
  w.exact_c = w.exact_w;
}

// The triangles of a hit BLAS leaf (data = first << 3 | count), in order.
template <bool kAnyHit>
__device__ __forceinline__ void test_leaf(Walk& w, const Pack& sc,
                                          const Rays& in, int data) {
  const int first = data >> 3;
  const int count = min(data & 7, 4);
  w.tris += count;
  for (int k = 0; k < count; ++k) {
    const int tri = first + k;
    const float4* tp = sc.tris + 3 * clip_index(tri, sc.n_tris);
    const float4 p0 = __ldg(tp), e1 = __ldg(tp + 1), e2 = __ldg(tp + 2);
    float t;
    if (tri_hit(w.co, w.cd, xyz(p0), xyz(e1), xyz(e2), in.t_min,
                kAnyHit ? w.t_max : w.best_t, &t)) {
      if (kAnyHit) {
        w.occluded = true;
        break;  // the rest of the leaf changes nothing
      }
      w.best_t = t;
      w.best_tri = tri;
      w.best_inst = w.cur_inst;
    }
  }
}

// Visit the node at the cursor: the slab test, then an instance's entry or
// a leaf's triangles, then the cursor step.
template <bool kAnyHit>
__device__ __forceinline__ void node_step(Walk& w, const Pack& sc,
                                          const Rays& in) {
  ++w.nodes;
  const int c = clip_index(w.in_blas ? w.bcur : w.tcur, sc.n_nodes);
  const int4 na = __ldg(sc.nodes + 2 * c);
  const int4 nb = __ldg(sc.nodes + 2 * c + 1);
  const int skip = na.w;
  const int data = nb.w;
  const bool leaf = data != 0;
  const float limit = kAnyHit ? w.t_max : w.best_t;
  const bool hit = aabb_hit(xyz_bits(na), xyz_bits(nb), w.co, w.ci, in.t_min,
                            limit, w.exact_c);
  if (!w.in_blas) {
    if (hit && leaf) {  // enter the instance's BLAS
      const int inst = data >> 3;
      const float4* m = sc.insts + 4 * clip_index(inst, sc.n_inst);
      const float4 r0 = __ldg(m), r1 = __ldg(m + 1), r2 = __ldg(m + 2);
      const int4 span = __ldg(reinterpret_cast<const int4*>(m + 3));
      const V o = load3(in.ro, w.ray);
      const V d = load3(in.rd, w.ray);
      w.co = V{__fadd_rn(dot(xyz(r0), o), r0.w),
               __fadd_rn(dot(xyz(r1), o), r1.w),
               __fadd_rn(dot(xyz(r2), o), r2.w)};
      w.cd = V{dot(xyz(r0), d), dot(xyz(r1), d), dot(xyz(r2), d)};
      w.ci = safe_inv3(w.cd);
      w.exact_c = w.exact_w || !(finite3(w.co) && finite3(w.cd));
      w.bcur = span.x;
      w.bend = span.y;
      w.cur_inst = inst;
      w.in_blas = true;
    }
    w.tcur = (hit && !leaf) ? w.tcur + 1 : skip;
  } else {
    if (hit && leaf) test_leaf<kAnyHit>(w, sc, in, data);
    w.bcur = (hit && !leaf) ? w.bcur + 1 : skip;
    if (w.bcur >= w.bend) leave_blas(w, in);
  }
}

template <bool kAnyHit>
__device__ __forceinline__ void finish(const Walk& w, const Out& out,
                                       int ray) {
  if (kAnyHit) {
    out.occ[ray] = w.occluded ? 1 : 0;
  } else {
    out.t[ray] = w.best_t;
    out.tri[ray] = w.best_tri;
    out.inst[ray] = w.best_inst;
  }
  if (out.nodes) {
    out.nodes[ray] = w.nodes;
    out.tris[ray] = w.tris;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(Pack sc, Rays in, Out out) {
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= in.r) return;
  const bool scene_exact = __ldg(sc.finite) == 0 || in.t_min != in.t_min;
  Walk w{};
  start(w, sc, in, ray, scene_exact);
  while (!walk_done(w, sc, in, kAnyHit)) node_step<kAnyHit>(w, sc, in);
  finish<kAnyHit>(w, out, ray);
}

template <bool kAnyHit>
cudaError_t launch(const Pack& sc, const Rays& in, const Out& out,
                   cudaStream_t stream) {
  const int blocks = (in.r + kThreads - 1) / kThreads;
  bvh_walk_kernel<kAnyHit><<<blocks, kThreads, 0, stream>>>(sc, in, out);
  return cudaGetLastError();
}

}  // namespace

// One walk of r rays (ro, rd: (r, 3) f32) over a packed scene
// (ops/intersect.py::WalkPack; every array 16-byte aligned). tmax_lane
// (r,) f32 or null for tmax_all; active (r,) bool or null for all.
// any_hit != 0 writes out_occ (r,) bool; else out_t, out_tri, out_inst (r,).
// stat_nodes / stat_tris (r,) i32, both or neither. r >= 1.
extern "C" int wrt_bvh_walk(
    const void* nodes, int n_nodes, int tlas_end, const void* tris,
    int n_tris, const void* insts, int n_inst, const int* finite,
    const float* ro, const float* rd, const float* tmax_lane, float tmax_all,
    float t_min, const unsigned char* active, int r, int any_hit,
    float* out_t, int* out_tri, int* out_inst, unsigned char* out_occ,
    int* stat_nodes, int* stat_tris, cudaStream_t stream) {
  const Pack sc{static_cast<const int4*>(nodes), n_nodes, tlas_end,
                static_cast<const float4*>(tris), n_tris,
                static_cast<const float4*>(insts), n_inst, finite};
  const Rays in{ro, rd, tmax_lane, tmax_all, t_min, active, r,
                4 * n_nodes + 64};
  const Out out{out_t, out_tri, out_inst, out_occ, stat_nodes, stat_tris};
  return static_cast<int>(any_hit ? launch<true>(sc, in, out, stream)
                                  : launch<false>(sc, in, out, stream));
}
