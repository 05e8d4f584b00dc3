// One bounce of the BVH path per lane: the whole bounce body in one kernel.
//
// Replaces the fori_loop body of webgpu_raytracer_tpu/ops/trace.py::
// ray_color (:307-437), which XLA compiles into one program; its plain
// version is ops/bvh_shade.py::bvh_shade_step, whose layouts it reads and
// writes. Per lane: the previous bounce's pending NEE resolved with the last
// shadow walk's verdict; the hit rebuilt from the closest walk's (tri, inst)
// (load_hit: the instance ray, Moller-Trumbore barycentrics, texture
// coordinates, the normal map, the inverse-transpose normals); emission with
// MIS (the light pdf of the hit triangle); one NEE light sample and its
// shadow ray; Lambert / GGX / dielectric sampling with the geometric-normal
// guard; Russian roulette after depth 3. Six PCG draws, in ray_color's
// order: 3 NEE, 2 BSDF, 1 RR. A lane the closest walk did not find (or
// that did not walk) draws its six and keeps its state.
//
// Two instantiations, as shade_rows.cu has: kTextured = false reads the
// scene's (1, 1, 1, 3) f32 placeholder texel; kTextured = true samples the
// level-0 quad table ((K * TH * TW, 4) int32, one 16-byte row holds the four
// bilinear corners as u8 codes), repeat wrap, as ops/trace.py::
// sample_texture does, every product and sum rounded on its own (not the
// dense sampler's fused lerps).
//
//   scene    BvhScene: the ShadePack of ops/bvh_shade.py::pack_shade, one
//            16-byte-aligned record a triangle (TRI_LAYOUT: its vertices'
//            positions, normals and uvs, its material rows), a light row
//            (LIGHT_LAYOUT: its triangle's world corners, uvs, base colour
//            and base-colour slot) and an instance (INST_LAYOUT: rows 0-2 of
//            inst_inv and inst_tf); the texture table
//   state    (13, n) f32 lane-minor rows of ops/bvh_shade.py, in and out
//   rng      (n,) int64 u32 PCG words (computed here as uint32_t)
//   ro, rd   (n, 3) f32 the walked rays; active (n,) bool or null (all)
//   tri, inst (n,) i32 the closest walk's hit (-1 miss)
//   occluded (n,) bool the last shadow walk's verdict, or null (none)
//   out      state_out (13, n), rng_out (n,); the next walks' inputs as
//            they read them: ro_next, rd_next (n, 3) and do_next (n,) bool;
//            sro, srd (n, 3), s_tmax (n,) and nee_lane (n,) bool. A ray a
//            lane does not walk is zero.
//
// Exactness. This file is compiled with --fmad=false (kernels.py): no
// product is contracted into a fused multiply-add, so every product, sum
// and quotient is rounded on its own, as the plain version's f32 tensor
// operations are, in the plain version's order (sums of three left to
// right, the instance transform row by row with its translation last,
// normalize as a quotient). A contracted product could move the texel
// position's floor() across an integer, or a comparison across its
// threshold. '/' and sqrtf are IEEE (no --use_fast_math); cosf / sinf are
// the precise versions and may differ from ATen's by ulps, the one source of
// disagreement left. The pack holds the tables' own bits, and a light's
// world corners are rounded as _light_tri_world rounds them, so reading it
// changes no result.
//
// What bounds it on an H100. A lane reads 94 bytes of its own (13 state
// floats, rng, ro, rd, tri, inst, the two masks) and writes 114 (state,
// rng, the two rays, do_next, s_tmax, nee_lane): 208 bytes, 206 at bounce
// 0, which has no masks (chip_smoke.py::bvh_shade_bytes adds the distinct
// table rows the found lanes need): ~0.016 ms of bytes at 512^2, ~0.13 ms at 1920x1080. A found
// lane also runs ~650 separately rounded operations, ~25 IEEE quotients
// and ~10 square roots, sin and cos, mostly on one material's branch.
// Timed without the host (chip_smoke.py::kernel_ms), the first design (one
// thread a lane, the tables read field by field through tri_v) took 0.033 ms
// at 512^2 and 0.18-0.21 ms at 1080p on an H100 at 700 W, about twice the
// byte bound at 512^2: the found lanes' arithmetic and latency, not the
// bytes, set the rest. This design:
// - reads the hit triangle, its instance and the picked light from the
//   ShadePack: one record each, a word at a time where it is first needed
//   (a light's corners already in world space, so its chain is one load
//   deep and its transform is gone);
// - draws the six PCG numbers first, and computes the hit's light pdf
//   only for an emitting hit (the only lane that reads it);
// - takes only the branch of the lane's material (the plain version
//   computes all three and selects);
// - launches 256 threads a block with launch bounds of 4 blocks an SM (64
//   registers; ptxas spills ~50-100 bytes, which L1 holds).
// Measured slower and not kept (PERF.md): each record read as 16-byte
// quads (95-120 registers, 2 blocks an SM), the (n, 3) rays staged through
// shared memory per block (with a bulk copy out) or per warp, a block-level
// partition of the lanes by material, and launch bounds of 1, 2, 3 or 5
// blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_math.cuh"

// The ShadePack (ops/bvh_shade.py::_Scene). At file scope, not in the
// unnamed namespace: a type of internal linkage in its signature would give
// the extern "C" entry point internal linkage too.
struct BvhScene {
  const int* tris;     // (T, 40) words: TRI_LAYOUT
  const int* lights;   // (L, 20) words: LIGHT_LAYOUT
  const float* insts;  // (I, 24) floats: INST_LAYOUT
  const void* textures;
  int n_tri, n_inst, light_count, tex_k, tex_h, tex_w;
};

namespace {

using namespace wrt;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // launch bounds: blocks an SM (64 registers)
constexpr int kNs = 13;  // state rows

__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}

// ops/bsdf.py::normalize: a quotient, not a reciprocal product.
__device__ __forceinline__ V3 normalize(V3 a) {
  return a / fmaxf(length(a), 1e-20f);
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// The packed records' widths and word offsets (ops/bvh_shade.py:
// TRI_LAYOUT, LIGHT_LAYOUT, INST_LAYOUT).
constexpr int kTriWords = 40, kLightWords = 20, kInstWords = 24;
constexpr int kP = 0, kN = 9, kUv = 18, kBase = 24, kMat = 27, kMrir = 28,
              kTex = 32, kEm = 36;
constexpr int kLv = 0, kLuv = 9, kLbase = 15, kLtex = 18;
constexpr int kTf = 12;  // inst_tf's rows after inst_inv's

__device__ __forceinline__ float wordf(const int* r, int w) {
  return __int_as_float(__ldg(r + w));
}

__device__ __forceinline__ V3 word3(const int* r, int w) {
  return {wordf(r, w), wordf(r, w + 1), wordf(r, w + 2)};
}

// Row i of a 4x4 matrix's rows (4 floats each) applied to a point: its dot
// product left to right, then the translation (ops/intersect.py::
// instance_ray, _light_tri_world).
__device__ __forceinline__ float xf_row(const float* m, int i, V3 p) {
  return __ldg(m + 4 * i) * p.x + __ldg(m + 4 * i + 1) * p.y +
         __ldg(m + 4 * i + 2) * p.z + __ldg(m + 4 * i + 3);
}

__device__ __forceinline__ V3 xf_point(const float* m, V3 p) {
  return {xf_row(m, 0, p), xf_row(m, 1, p), xf_row(m, 2, p)};
}

__device__ __forceinline__ V3 xf_dir(const float* m, V3 d) {
  auto row = [&](int i) {
    return __ldg(m + 4 * i) * d.x + __ldg(m + 4 * i + 1) * d.y +
           __ldg(m + 4 * i + 2) * d.z;
  };
  return {row(0), row(1), row(2)};
}

// ops/trace.py::_inv_transpose_dir: normalize((n, 0) * inv), inv's rows
// 0-2 in m.
__device__ __forceinline__ V3 inv_transpose_dir(const float* m, V3 n) {
  auto col = [&](int j) {
    return n.x * __ldg(m + j) + n.y * __ldg(m + 4 + j) +
           n.z * __ldg(m + 8 + j);
  };
  return normalize(V3{col(0), col(1), col(2)});
}

__device__ __forceinline__ V3 corner(int word) {
  const float s = (float)(1.0 / 255.0);
  return {(float)((word >> 16) & 0xFF) * s, (float)((word >> 8) & 0xFF) * s,
          (float)(word & 0xFF) * s};
}

// Where ops/trace.py::sample_texture samples (u, v) in a layer: the texel
// row within the layer and the bilinear weights, the same for every slot.
struct TexSite {
  int row;
  float wx, wy;
};

template <bool kTextured>
__device__ __forceinline__ TexSite tex_site(const BvhScene& s, float uu,
                                            float vv) {
  if constexpr (!kTextured) {
    return {0, 0.0f, 0.0f};
  } else {
    const float fx = (uu - floorf(uu)) * (float)s.tex_w - 0.5f;
    const float fy = (vv - floorf(vv)) * (float)s.tex_h - 0.5f;
    const int x0 = (int)floorf(fx);
    const int y0 = (int)floorf(fy);
    return {floor_mod(y0, s.tex_h) * s.tex_w + floor_mod(x0, s.tex_w),
            fx - (float)x0, fy - (float)y0};
  }
}

// A slot's texel quad at a site (read only where the slot is >= 0).
template <bool kTextured>
__device__ __forceinline__ int4 tex_quad(const BvhScene& s, int tex,
                                         TexSite site) {
  if constexpr (kTextured) {
    if (tex >= 0) {
      const int layer = min(tex, s.tex_k - 1);
      return __ldg((const int4*)s.textures +
                   (layer * s.tex_h * s.tex_w + site.row));
    }
  }
  return {0, 0, 0, 0};
}

// ops/trace.py::sample_texture for one lane: white where tex < 0; the
// placeholder's texel, or the bilinear blend of the quad.
template <bool kTextured>
__device__ __forceinline__ V3 tex_value(int tex, int4 q, TexSite site,
                                        V3 placeholder) {
  if (tex < 0) return {1.0f, 1.0f, 1.0f};
  if constexpr (!kTextured) {
    return placeholder;
  } else {
    const float wx = site.wx, wy = site.wy;
    const V3 top = corner(q.x) * (1.0f - wx) + corner(q.y) * wx;
    const V3 bot = corner(q.z) * (1.0f - wx) + corner(q.w) * wx;
    return top * (1.0f - wy) + bot * wy;
  }
}

// ops/bsdf.py's GGX value, pdf and sample and its dielectric.
__device__ __forceinline__ V3 fresnel_schlick(float cos_theta, V3 f0) {
  const float p = pow5(clamp01(1.0f - cos_theta));
  return f0 + V3{(1.0f - f0.x) * p, (1.0f - f0.y) * p, (1.0f - f0.z) * p};
}

__device__ __forceinline__ V3 eval_ggx(V3 n, V3 v, V3 l, float roughness,
                                       V3 f0) {
  const V3 h = normalize(v + l);
  const float n_dot_v = fmaxf(dot(n, v), 1e-4f);
  const float n_dot_l = fmaxf(dot(n, l), 1e-4f);
  const float n_dot_h = fmaxf(dot(n, h), 1e-4f);
  const float v_dot_h = fmaxf(dot(v, h), 1e-4f);
  const float a2 = roughness * roughness;
  const float dg = ggx_d(n_dot_h, a2) * ggx_g(n_dot_v, n_dot_l, a2);
  const V3 f = fresnel_schlick(v_dot_h, f0);
  const float den = 4.0f * n_dot_v * n_dot_l;
  return {dg * f.x / den, dg * f.y / den, dg * f.z / den};
}

__device__ __forceinline__ float ggx_pdf(V3 n, V3 v, V3 l, float roughness) {
  const V3 h = normalize(v + l);
  const float n_dot_h = dot(n, h);
  const float v_dot_h = fmaxf(dot(v, h), 0.0f);
  return (ggx_d(n_dot_h, roughness * roughness) * fmaxf(n_dot_h, 0.0f)) /
         (4.0f * fmaxf(v_dot_h, 1e-8f));
}

__device__ __forceinline__ Scatter sample_ggx(V3 n, V3 v, float roughness,
                                              V3 f0, float r1, float r2) {
  const float a = roughness;
  const float phi = kTwoPi * r1;
  const float cos_theta =
      sqrtf(fmaxf((1.0f - r2) / (1.0f + (a * a - 1.0f) * r2), 0.0f));
  const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  const V3 h_local = {sin_theta * cosf(phi), sin_theta * sinf(phi),
                      cos_theta};
  V3 u, vv;
  build_onb(n, u, vv);
  const V3 h = local_to_world(u, vv, n, h_local);
  const V3 l = reflect(-v, h);
  const bool below = dot(n, l) <= 0.0f;

  const float n_dot_v = fmaxf(dot(n, v), 1e-4f);
  const float n_dot_l = fmaxf(dot(n, l), 1e-4f);
  const float n_dot_h = fmaxf(dot(n, h), 1e-4f);
  const float v_dot_h = fmaxf(dot(v, h), 1e-4f);
  const float a2 = a * a;
  const float d = ggx_d(n_dot_h, a2);
  const float g = ggx_g(n_dot_v, n_dot_l, a2);
  const V3 f = fresnel_schlick(v_dot_h, f0);

  const float pdf = (d * n_dot_h) / (4.0f * v_dot_h);
  const float scale = g * v_dot_h / (n_dot_v * n_dot_h);
  const V3 zero = {0.0f, 0.0f, 0.0f};
  const V3 tp = pdf > 1e-6f ? f * scale : zero;
  return {below ? zero : l, below ? 0.0f : pdf, below ? zero : tp,
          roughness < 0.01f};
}

__device__ __forceinline__ Scatter sample_dielectric(V3 dir, V3 normal,
                                                     float ior, V3 albedo,
                                                     float r1) {
  const bool front_face = dot(dir, normal) < 0.0f;
  const float ratio = front_face ? 1.0f / ior : ior;
  const V3 n = front_face ? normal : -normal;
  const V3 unit = normalize(dir);
  const float cos_theta = fminf(dot(-unit, n), 1.0f);
  const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  const bool cannot_refract = ratio * sin_theta > 1.0f;
  const bool do_reflect =
      cannot_refract || reflectance_dielectric(cos_theta, ratio) > r1;
  const V3 d = do_reflect ? reflect(unit, n) : refract(unit, n, ratio);
  return {d, 1.0f, albedo, true};
}

__device__ __forceinline__ V3 row3(const float* t, int i) {
  return {t[3 * i], t[3 * i + 1], t[3 * i + 2]};
}

__device__ __forceinline__ void put3(float* t, int i, V3 v) {
  t[3 * i] = v.x;
  t[3 * i + 1] = v.y;
  t[3 * i + 2] = v.z;
}

template <bool kTextured>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvh_shade_kernel(BvhScene s, const float* __restrict__ state,
                 const long long* __restrict__ rng,
                 const float* __restrict__ ro_in,
                 const float* __restrict__ rd_in,
                 const bool* __restrict__ active,
                 const int* __restrict__ tri_in,
                 const int* __restrict__ inst_in,
                 const bool* __restrict__ occluded, int depth, int max_depth,
                 int n, float* __restrict__ out,
                 long long* __restrict__ rng_out, float* __restrict__ ro_next,
                 float* __restrict__ rd_next, bool* __restrict__ do_next_out,
                 float* __restrict__ sro_out, float* __restrict__ srd_out,
                 float* __restrict__ s_tmax_out,
                 bool* __restrict__ nee_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane < n) {
    const size_t N = (size_t)n;
    auto S = [&](int r) { return state[r * N + lane]; };
    V3 throughput = {S(0), S(1), S(2)};
    V3 radiance = {S(3), S(4), S(5)};
    float prev_pdf = S(6);
    bool specular = S(7) > 0.5f;
    const V3 pending = {S(8), S(9), S(10)};
    const bool take =
        S(11) > 0.5f && !(occluded != nullptr && occluded[lane]);
    float lane_rays = S(12);
    uint32_t rs = (uint32_t)rng[lane];
    const V3 zero = {0.0f, 0.0f, 0.0f};

    // --- the previous bounce's NEE, with the last shadow walk's verdict ---
    radiance = radiance + (take ? pending : zero);

    // The bounce's six draws depend on the rng word alone: 3 NEE, 2 BSDF,
    // 1 RR, drawn by every lane.
    const float r0 = pcg(rs);
    const float r1 = pcg(rs);
    const float r2 = pcg(rs);
    const float s1 = pcg(rs);
    const float s2 = pcg(rs);
    const float rr = pcg(rs);

    const int inst = inst_in[lane];
    const bool found = inst >= 0 && (active == nullptr || active[lane]);
    V3 new_pending = zero, ro_n = zero, rd_n = zero, sro = zero, srd = zero;
    float s_tmax = 0.0f;
    bool pend = false, nee_lane = false, do_next = false;
    if (found) {
      const V3 ro = row3(ro_in, lane);
      const V3 rd = row3(rd_in, lane);
      const float lc_f = (float)max(s.light_count, 1);
      const int pick =
          min(max((int)(r0 * lc_f), 0), max(s.light_count - 1, 0));
      // The lane's records, each word read where it is first needed.
      const int* tr =
          s.tris + kTriWords * (size_t)clamp_index(tri_in[lane], s.n_tri);
      const float* inv =
          s.insts + kInstWords * (size_t)clamp_index(inst, s.n_inst);
      const int* lr = s.lights + kLightWords * (size_t)pick;

      // --- load_hit ---
      const V3 lro = xf_point(inv, ro);
      const V3 lrd = xf_dir(inv, rd);
      const V3 v0 = word3(tr, kP);
      const V3 p1 = word3(tr, kP + 3);
      const V3 p2 = word3(tr, kP + 6);
      const V3 e1 = p1 - v0;
      const V3 e2 = p2 - v0;
      const V3 sv = lro - v0;
      const V3 h = cross(lrd, e2);
      const float fi = 1.0f / dot(e1, h);
      const float u_b = fi * dot(sv, h);
      const V3 qv = cross(sv, e1);
      const float v_b = fi * dot(lrd, qv);
      const float w = 1.0f - u_b - v_b;
      const float hit_t = fi * dot(e2, qv);
      const float tex_u = wordf(tr, kUv) * w + wordf(tr, kUv + 2) * u_b +
                          wordf(tr, kUv + 4) * v_b;
      const float tex_v = wordf(tr, kUv + 1) * w +
                          wordf(tr, kUv + 3) * u_b +
                          wordf(tr, kUv + 5) * v_b;
      const int t_base = __ldg(tr + kTex), t_mr = __ldg(tr + kTex + 1),
                t_nrm = __ldg(tr + kTex + 2), t_em = __ldg(tr + kTex + 3);
      // The hit's four slots share one texel position.
      const TexSite site = tex_site<kTextured>(s, tex_u, tex_v);
      V3 placeholder = {1.0f, 1.0f, 1.0f};
      if constexpr (!kTextured) {
        const float* t = (const float*)s.textures;
        placeholder = {__ldg(t), __ldg(t + 1), __ldg(t + 2)};
      }
      const V3 ln = normalize(word3(tr, kN) * w + word3(tr, kN + 3) * u_b +
                              word3(tr, kN + 6) * v_b);
      const V3 albedo =
          word3(tr, kBase) *
          tex_value<kTextured>(t_base, tex_quad<kTextured>(s, t_base, site),
                               site, placeholder);
      V3 ln_final = ln;
      if (t_nrm >= 0) {
        // Tangent-space normal mapping with the edge-1 tangent.
        const V3 mm = tex_value<kTextured>(
            t_nrm, tex_quad<kTextured>(s, t_nrm, site), site, placeholder);
        const V3 n_map = {mm.x * 2.0f - 1.0f, mm.y * 2.0f - 1.0f,
                          mm.z * 2.0f - 1.0f};
        const V3 t_axis = normalize(e1);
        const V3 b_axis = normalize(cross(ln, t_axis));
        ln_final = normalize(t_axis * n_map.x + b_axis * n_map.y +
                             ln * n_map.z);
      }
      const V3 s_normal = inv_transpose_dir(inv, ln_final);
      const V3 s_geom = inv_transpose_dir(inv, normalize(cross(e1, e2)));

      const V3 hit_p = ro + rd * hit_t;
      const V3 normal = dot(rd, s_normal) < 0.0f ? s_normal : -s_normal;
      const V3 geom_n = dot(rd, s_geom) < 0.0f ? s_geom : -s_geom;

      const int mat = __ldg(tr + kMat);
      const V3 mrir = word3(tr, kMrir);
      float metallic = mrir.x, rough = mrir.y;
      if (t_mr >= 0) {
        const V3 mr = tex_value<kTextured>(
            t_mr, tex_quad<kTextured>(s, t_mr, site), site, placeholder);
        metallic = mrir.x * mr.z;
        rough = mrir.y * mr.y;
      }
      const float roughness = fmaxf(rough, 0.005f);
      V3 emissive = word3(tr, kEm);
      if (t_em >= 0) {
        emissive = emissive * tex_value<kTextured>(
                                  t_em, tex_quad<kTextured>(s, t_em, site),
                                  site, placeholder);
      }
      const V3 f0 = {(albedo.x - 0.04f) * metallic + 0.04f,
                     (albedo.y - 0.04f) * metallic + 0.04f,
                     (albedo.z - 0.04f) * metallic + 0.04f};

      // --- emissive / light hit with MIS ---
      const bool is_light = mat == 3;
      const bool has_em = is_light || length(emissive) > 1e-4f;
      if (has_em) {
        // The light pdf of the hit triangle (only an emitting hit reads
        // it): its world corners under inst_tf's rows.
        const float* tf = inv + kTf;
        const V3 hv0 = xf_point(tf, v0);
        const V3 hcr =
            cross(xf_point(tf, p1) - hv0, xf_point(tf, p2) - hv0);
        const float harea = length(hcr) * 0.5f;
        const float cos_tl = fmaxf(dot(normalize(hcr), -rd), 0.0f);
        float light_pdf =
            (hit_t * hit_t) / fmaxf(cos_tl * harea, 1e-20f) / lc_f;
        light_pdf = cos_tl >= 1e-4f ? light_pdf : 0.0f;
        const float mis_w =
            specular ? 1.0f : power_heuristic(prev_pdf, light_pdf);
        const V3 em_val = is_light ? albedo : emissive;
        radiance = radiance + throughput * em_val * mis_w;
      }
      bool live = !is_light;

      // --- NEE: a point on the picked light, the shadow ray ---
      const float sqrt_r1 = sqrtf(r1);
      const float lu = 1.0f - sqrt_r1;
      const float lv = r2 * sqrt_r1;
      const float lw = 1.0f - lu - lv;
      const V3 lv0 = word3(lr, kLv), lv1 = word3(lr, kLv + 3),
               lv2 = word3(lr, kLv + 6);
      const V3 lpnt = lv0 * lu + lv1 * lv + lv2 * lw;
      const V3 lcr = cross(lv1 - lv0, lv2 - lv0);
      const V3 ln_raw = normalize(lcr);
      const float larea = length(lcr) * 0.5f;
      const V3 l_dir = lpnt - hit_p;
      const float dist_sq = dot(l_dir, l_dir);
      const float ldist = sqrtf(dist_sq);
      const V3 ldir = l_dir / fmaxf(ldist, 1e-20f);
      const float cos_theta_l = fmaxf(dot(ln_raw, -ldir), 0.0f);
      const float lt_u = wordf(lr, kLuv) * lu + wordf(lr, kLuv + 2) * lv +
                         wordf(lr, kLuv + 4) * lw;
      const float lt_v = wordf(lr, kLuv + 1) * lu +
                         wordf(lr, kLuv + 3) * lv +
                         wordf(lr, kLuv + 5) * lw;
      const TexSite l_site = tex_site<kTextured>(s, lt_u, lt_v);
      const int l_tex = __ldg(lr + kLtex);
      const V3 L =
          word3(lr, kLbase) *
          tex_value<kTextured>(l_tex, tex_quad<kTextured>(s, l_tex, l_site),
                               l_site, placeholder);
      float lpdf = dist_sq / fmaxf(cos_theta_l * larea, 1e-20f) / lc_f;
      const bool lvalid =
          cos_theta_l >= 1e-6f && larea > 0.0f && s.light_count > 0;
      lpdf = lvalid ? lpdf : 0.0f;

      nee_lane = live && mat != 2 && lpdf > 0.0f;
      const float eps = offset_eps(hit_p);
      const float end_eps = fmaxf(eps, offset_eps(hit_p + ldir * ldist));
      const float n_dot_l = fmaxf(dot(normal, ldir), 0.0f);
      V3 bsdf_val;
      float bsdf_pdf;
      if (mat == 0) {
        bsdf_val = albedo / kPi;
        bsdf_pdf = n_dot_l / kPi;
      } else {
        bsdf_val = eval_ggx(normal, -rd, ldir, roughness, f0);
        bsdf_pdf = ggx_pdf(normal, -rd, ldir, roughness);
      }
      pend = nee_lane && bsdf_pdf > 0.0f;
      if (pend) {
        const float wgt = power_heuristic(lpdf, bsdf_pdf) * n_dot_l /
                          fmaxf(lpdf, 1e-20f);
        new_pending = throughput * bsdf_val * L * wgt;
      }
      if (nee_lane) {
        sro = hit_p + geom_n * eps;
        srd = ldir;
        s_tmax = ldist - 2.0f * end_eps;
      }

      // --- BSDF sampling ---
      Scatter sc;
      if (mat == 2) {
        sc = sample_dielectric(rd, normal, mrir.z, albedo, s1);
      } else if (mat == 1) {
        sc = sample_ggx(normal, -rd, roughness, f0, s1, s2);
      } else {
        sc = sample_diffuse(normal, albedo, s1, s2);
      }
      // Geometric-normal guard for non-dielectrics.
      const bool bad = mat != 2 && dot(sc.dir, geom_n) <= 0.0f;
      const float pdf = bad ? 0.0f : sc.pdf;
      const V3 tp = bad ? zero : sc.throughput;
      live = live && pdf > 0.0f && length(tp) > 0.0f;
      if (live) {
        throughput = throughput * tp;
        prev_pdf = pdf;
        specular = sc.specular;
      }
      const V3 off_n = dot(sc.dir, geom_n) > 0.0f ? geom_n : -geom_n;

      // --- Russian roulette after depth 3 ---
      const float p = fmaxf(throughput.x, fmaxf(throughput.y, throughput.z));
      const bool do_rr = live && depth > 3;
      live = live && !(do_rr && rr > p);
      if (do_rr && rr <= p) throughput = throughput / fmaxf(p, 1e-20f);
      do_next = live && depth < max_depth - 1;
      if (do_next) {
        ro_n = hit_p + off_n * eps;
        rd_n = sc.dir;
      }
      lane_rays =
          lane_rays + (nee_lane ? 1.0f : 0.0f) + (do_next ? 1.0f : 0.0f);
    }

    const float o[kNs] = {throughput.x, throughput.y, throughput.z,
                          radiance.x, radiance.y, radiance.z,
                          prev_pdf, specular ? 1.0f : 0.0f,
                          new_pending.x, new_pending.y, new_pending.z,
                          pend ? 1.0f : 0.0f, lane_rays};
#pragma unroll
    for (int r = 0; r < kNs; ++r) out[r * N + lane] = o[r];
    rng_out[lane] = (long long)rs;
    do_next_out[lane] = do_next;
    s_tmax_out[lane] = s_tmax;
    nee_out[lane] = nee_lane;
    put3(ro_next, lane, ro_n);
    put3(rd_next, lane, rd_n);
    put3(sro_out, lane, sro);
    put3(srd_out, lane, srd);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). `scene` is a
// host pointer, copied into the launch; textured != 0 takes the quad-table
// instantiation (the table 16-byte aligned, as the pack's records are).
extern "C" int wrt_bvh_shade(const BvhScene* scene, int textured,
                             const float* state, const long long* rng,
                             const float* ro, const float* rd,
                             const bool* active, const int* tri,
                             const int* inst, const bool* occluded, int depth,
                             int max_depth, int n, float* out,
                             long long* rng_out, float* ro_next,
                             float* rd_next, bool* do_next, float* sro,
                             float* srd, float* s_tmax, bool* nee_lane,
                             void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const cudaStream_t st = (cudaStream_t)stream;
    if (textured) {
      bvh_shade_kernel<true><<<blocks, kThreads, 0, st>>>(
          *scene, state, rng, ro, rd, active, tri, inst, occluded, depth,
          max_depth, n, out, rng_out, ro_next, rd_next, do_next, sro, srd,
          s_tmax, nee_lane);
    } else {
      bvh_shade_kernel<false><<<blocks, kThreads, 0, st>>>(
          *scene, state, rng, ro, rd, active, tri, inst, occluded, depth,
          max_depth, n, out, rng_out, ro_next, rd_next, do_next, sro, srd,
          s_tmax, nee_lane);
    }
  }
  return (int)cudaGetLastError();
}
