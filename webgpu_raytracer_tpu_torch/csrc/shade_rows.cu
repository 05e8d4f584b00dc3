// One bounce of shading per lane: the whole bounce update in one kernel.
//
// Replaces webgpu_raytracer_tpu/ops/shade_rows.py::_shade_kernel (its body
// is the pure-jnp shade_step). Semantics and layouts are that function's:
// the hit rebuilt from the winner row, emissive light with MIS, one NEE
// light sample, Lambert / GGX / dielectric sampling with the
// geometric-normal guard, Russian roulette after depth 3, and the
// resolution of the previous bounce's NEE. Six PCG draws, in the same
// order: 3 NEE, 2 BSDF, 1 RR.
//
// Two instantiations. kTextured = false is the TPU kernel's scope, the 1x1
// white texel (wrt_shade_rows). kTextured = true (wrt_shade_rows_textured)
// also samples textures as the JAX package's per-ray ray_color_dense does,
// which the TPU kernel cannot (its texel gathers do not run inside a
// Pallas kernel): base colour and normal map at level 0 on bounce 0 and at
// level 1 after it, metallic-roughness (z scales metallic, y roughness),
// emissive and the picked light's base colour at level 1. A level is the
// (N, 4) int32 quad table of ops/fetch.py (one 16-byte row holds the four
// bilinear corners as u8 codes) with its (K, TH, TW); a lane reads a quad
// only where its slot index is >= 0 (miss lanes' zeroed rows are gated on
// idx >= 0, metallic-roughness and emissive on the live lanes).
//
//   state    (20, n) f32   rows as in ops/shade_rows.py (lane-minor)
//   rng      (n,) int64    u32 PCG words (computed here as uint32_t)
//   rowT     (40, n) f32   winner shade rows; idx (n,) int32 (-1 miss)
//   lrows    (L, 40) f32   light rows; the NEE pick is a direct clipped
//                          index, so there is no cap on L (the TPU kernel's
//                          one-hot fetch capped it at 128)
//   out      (27, n) f32, rng_out (n,) int64
//   rays8    (8, 2n) f32   the next fused sweep's ray stack: shadow lanes
//                          [0, n) = [srd, sro, s_tmax, 0], extension lanes
//                          [n, 2n) = [rd, ro, T_MAX if do_next else 0, 0]
//
// Where the JAX code selects between branches computed for every lane
// (jnp.where), this kernel computes the selected branch only; the result
// is the same. Built without --use_fast_math: '/' and sqrtf are IEEE,
// sinf / cosf are the precise versions; FMA contraction is nvcc's default.
// The texture coordinates, the barycentrics that feed them and the
// sampler's texel position are the exception: they are computed with the
// __f*_rn intrinsics, each product and sum rounded as the plain version
// rounds it, since a contracted product can move a floor() across an
// integer and read another texel; the bilinear lerps are __fmaf_rn where
// the plain version emulates the fused multiply-add of XLA's sampler.
//
// What bounds it on an H100: memory traffic. A lane reads 252 bytes (20
// state and 40 row floats, its idx and rng word) and writes 180 (27 state
// floats, its rng word, 16 ray-stack floats): 113 MB at cornell 512^2
// (262,144 lanes), 0.9 GB at 1920x1080, against some 400 flops a lane.
// Measured on an H100 80GB HBM3 at 700 W: 0.068 ms at 512^2 (half the
// 3.35 TB/s roofline; the launch is short) and 0.30 ms at 1080p (~90% of
// it). The textured instantiation adds 16 bytes per texel quad a lane
// reads (at most five: base, normal, metallic-roughness, emissive, light),
// random reads that stay in L2 while the levels read fit it (one 1024^2
// layer is 16 MB). The design makes it one pass: one thread per lane,
// every intermediate in registers, loads and stores lane-minor so each
// warp touches 128 contiguous bytes per row, and the next sweep's ray
// stack written here rather than assembled by separate copies. The light
// rows and the texel quads are read through the read-only cache.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_math.cuh"

namespace {

using namespace wrt;

constexpr int kThreads = 256;
constexpr int kShadeK = 40;
constexpr int kNsOut = 27;
constexpr float kTMax = 1e30f;

__device__ __forceinline__ V3 normalize(V3 a) {
  return a * (1.0f / fmaxf(length(a), 1e-20f));
}

__device__ __forceinline__ V3 fresnel_schlick(float cos_theta, V3 f0) {
  const float p = pow5(clamp01(1.0f - cos_theta));
  return f0 + (V3{p, p, p} - f0 * p);
}

__device__ __forceinline__ V3 eval_ggx(V3 n, V3 v, V3 l, float roughness,
                                       V3 f0) {
  const V3 h = normalize(v + l);
  const float n_dot_v = fmaxf(dot(n, v), 1e-4f);
  const float n_dot_l = fmaxf(dot(n, l), 1e-4f);
  const float n_dot_h = fmaxf(dot(n, h), 1e-4f);
  const float v_dot_h = fmaxf(dot(v, h), 1e-4f);
  const float a2 = roughness * roughness;
  const float d = ggx_d(n_dot_h, a2);
  const float g = ggx_g(n_dot_v, n_dot_l, a2);
  const V3 f = fresnel_schlick(v_dot_h, f0);
  return f * (d * g / (4.0f * n_dot_v * n_dot_l));
}

__device__ __forceinline__ float ggx_pdf(V3 n, V3 v, V3 l, float roughness) {
  const V3 h = normalize(v + l);
  const float n_dot_h = dot(n, h);
  const float v_dot_h = fmaxf(dot(v, h), 0.0f);
  return (ggx_d(n_dot_h, roughness * roughness) * fmaxf(n_dot_h, 0.0f)) /
         (4.0f * fmaxf(v_dot_h, 1e-8f));
}

// One texture level: the quad table's rows and its (K, TH, TW).
struct TexLevel {
  const int4* quads;
  int k, th, tw;
};

__device__ __forceinline__ float dot_rn(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ V3 cross_rn(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

// a * wa + b * wb + c * wc, every product and sum rounded, in this order.
__device__ __forceinline__ float bary_rn(float a, float wa, float b, float wb,
                                         float c, float wc) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)),
                   __fmul_rn(c, wc));
}


__device__ __forceinline__ V3 corner(int word) {
  const float s = (float)(1.0 / 255.0);
  return {__fmul_rn((float)((word >> 16) & 0xFF), s),
          __fmul_rn((float)((word >> 8) & 0xFF), s),
          __fmul_rn((float)(word & 0xFF), s)};
}

// a * b + c per component, rounded once.
__device__ __forceinline__ V3 fma_v3(V3 a, float b, V3 c) {
  return {__fmaf_rn(a.x, b, c.x), __fmaf_rn(a.y, b, c.y),
          __fmaf_rn(a.z, b, c.z)};
}

__device__ __forceinline__ V3 mul_rn(V3 a, float s) {
  return {__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s)};
}

// ops/fetch.py::sample_texture_v3 for a lane whose slot index is >= 0:
// the layer clamped to [0, K - 1], repeat wrap, one 16-byte quad read.
__device__ __forceinline__ V3 sample_tex(const TexLevel& t, int tex, float u,
                                         float v) {
  const int layer = min(max(tex, 0), t.k - 1);
  const float fx =
      __fsub_rn(__fmul_rn(__fsub_rn(u, floorf(u)), (float)t.tw), 0.5f);
  const float fy =
      __fsub_rn(__fmul_rn(__fsub_rn(v, floorf(v)), (float)t.th), 0.5f);
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const int row = (layer * t.th + floor_mod((int)y0, t.th)) * t.tw +
                  floor_mod((int)x0, t.tw);
  const int4 q = __ldg(t.quads + row);
  const float wx = __fsub_rn(fx, x0);
  const float wy = __fsub_rn(fy, y0);
  const V3 top = fma_v3(corner(q.y), wx, mul_rn(corner(q.x),
                                                __fsub_rn(1.0f, wx)));
  const V3 bot = fma_v3(corner(q.w), wx, mul_rn(corner(q.z),
                                                __fsub_rn(1.0f, wx)));
  return fma_v3(top, __fsub_rn(1.0f, wy), mul_rn(bot, wy));
}

__device__ __forceinline__ Scatter sample_ggx(V3 n, V3 v, float roughness,
                                              V3 f0, float r1, float r2) {
  const float a = roughness;
  const float phi = kTwoPi * r1;
  const float cos_theta =
      sqrtf(fmaxf(0.0f, (1.0f - r2) / (1.0f + (a * a - 1.0f) * r2)));
  const float sin_theta = sqrtf(fmaxf(0.0f, 1.0f - cos_theta * cos_theta));
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
  const float scale = pdf > 1e-6f ? g * v_dot_h / (n_dot_v * n_dot_h) : 0.0f;
  const V3 zero = {0.0f, 0.0f, 0.0f};
  return {below ? zero : l, below ? 0.0f : pdf, below ? zero : f * scale,
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

template <bool kTextured>
__global__ void __launch_bounds__(kThreads)
shade_rows_kernel(const float* __restrict__ state,
                  const long long* __restrict__ rng,
                  const float* __restrict__ rowT, const int* __restrict__ idx,
                  const float* __restrict__ lrows, int light_count, int depth,
                  int max_depth, int n, TexLevel tex0, TexLevel tex1,
                  float* __restrict__ out, long long* __restrict__ rng_out,
                  float* __restrict__ rays8) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t N = (size_t)n;
  auto S = [&](int r) { return state[r * N + lane]; };
  auto RW = [&](int r) { return rowT[r * N + lane]; };
  auto RV = [&](int r) { return V3{RW(r), RW(r + 1), RW(r + 2)}; };

  const V3 ro = {S(1), S(2), S(3)};
  const V3 rd = {S(4), S(5), S(6)};
  const V3 throughput = {S(7), S(8), S(9)};
  V3 radiance = {S(10), S(11), S(12)};
  const float prev_pdf = S(13);
  const bool specular_bounce = S(14) > 0.5f;
  const bool nee_prev = S(15) > 0.5f;
  const V3 pending = {S(16), S(17), S(18)};
  const bool occluded_prev = S(19) > 0.5f;
  uint32_t rs = (uint32_t)rng[lane];

  // --- resolve the PREVIOUS bounce's NEE with this sweep's occlusion ---
  const bool take_prev = nee_prev && !occluded_prev;
  radiance = radiance + pending * (take_prev ? 1.0f : 0.0f);

  const bool idx_ok = idx[lane] >= 0;
  bool active = S(0) > 0.5f && idx_ok;

  // --- hit reconstruction from the winner row (white texel) ---
  const V3 v0 = RV(0), e1 = RV(3), e2 = RV(6);
  const V3 sv = ro - v0;
  const V3 h = cross(rd, e2);
  const float a = dot(e1, h);
  const float f = 1.0f / (fabsf(a) > 1e-20f ? a : 1e-20f);
  const float u = f * dot(sv, h);
  const V3 q = cross(sv, e1);
  const float v = f * dot(rd, q);
  const float w = 1.0f - u - v;
  const float hit_t = idx_ok ? f * dot(e2, q) : 0.0f;

  const V3 ln = normalize(RV(9) * w + RV(12) * u + RV(15) * v);
  const bool nt_on = idx_ok && RW(33) >= 0.0f;  // tex[2]: normal map
  const V3 t_axis = normalize(e1);
  const V3 b_axis = normalize(cross(ln, t_axis));
  V3 ln_mapped;
  V3 albedo = RV(24);
  [[maybe_unused]] float tex_u = 0.0f, tex_v = 0.0f;
  if constexpr (kTextured) {
    // The hit's texture coordinates from barycentrics rounded as the plain
    // version rounds them; base colour and normal map at level 0 on
    // bounce 0, at level 1 after it.
    const V3 h_rn = cross_rn(rd, e2);
    const float a_rn = dot_rn(e1, h_rn);
    const float f_rn = 1.0f / (fabsf(a_rn) > 1e-20f ? a_rn : 1e-20f);
    const float bu = __fmul_rn(f_rn, dot_rn(sv, h_rn));
    const float bv = __fmul_rn(f_rn, dot_rn(rd, cross_rn(sv, e1)));
    const float bw = __fsub_rn(__fsub_rn(1.0f, bu), bv);
    tex_u = bary_rn(RW(18), bw, RW(20), bu, RW(22), bv);
    tex_v = bary_rn(RW(19), bw, RW(21), bu, RW(23), bv);
    const TexLevel level = depth == 0 ? tex0 : tex1;
    const int base_tex = idx_ok ? (int)RW(31) : -1;
    if (base_tex >= 0) albedo = albedo * sample_tex(level, base_tex, tex_u,
                                                    tex_v);
    V3 n_map = {1.0f, 1.0f, 1.0f};
    if (nt_on) n_map = sample_tex(level, (int)RW(33), tex_u, tex_v) * 2.0f +
                       -1.0f;
    ln_mapped = normalize(t_axis * n_map.x + b_axis * n_map.y + ln * n_map.z);
  } else {
    ln_mapped = normalize(t_axis + b_axis + ln);
  }
  const V3 s_normal = sel(nt_on, ln_mapped, ln);
  const V3 s_geom = normalize(cross(e1, e2));

  const V3 hit_p = ro + rd * hit_t;
  const V3 normal = dot(rd, s_normal) < 0.0f ? s_normal : -s_normal;
  const V3 geom_n = dot(rd, s_geom) < 0.0f ? s_geom : -s_geom;

  const float mat = RW(27);
  float metallic = RW(28);
  float rough = RW(29);
  V3 emissive = RV(35);
  if constexpr (kTextured) {
    // metallic-roughness and emissive: level 1, live lanes only.
    const int mr_tex = active ? (int)RW(32) : -1;
    if (mr_tex >= 0) {
      const V3 mr = sample_tex(tex1, mr_tex, tex_u, tex_v);
      metallic = metallic * mr.z;
      rough = rough * mr.y;
    }
    const int em_tex = active ? (int)RW(34) : -1;
    if (em_tex >= 0) emissive = emissive * sample_tex(tex1, em_tex, tex_u,
                                                      tex_v);
  }
  const float roughness = fmaxf(rough, 0.005f);
  const float ior = RW(30);
  const V3 f0 = albedo * metallic + 0.04f * (1.0f - metallic);

  // --- emissive / light hit with MIS ---
  const bool is_light = mat == 3.0f;
  const bool has_em = is_light || length(emissive) > 1e-4f;
  const V3 em_val = is_light ? albedo : emissive;
  const V3 cr = cross(e1, e2);
  const float area = length(cr) * 0.5f;
  const V3 n_raw = normalize(cr);
  const float cos_tl = fmaxf(dot(n_raw, -rd), 0.0f);
  const float lc_f = fmaxf((float)light_count, 1.0f);
  float lp = (hit_t * hit_t) / fmaxf(cos_tl * area, 1e-20f) / lc_f;
  lp = cos_tl >= 1e-4f ? lp : 0.0f;
  const float mis_w =
      specular_bounce ? 1.0f : power_heuristic(prev_pdf, lp);
  const float add = (active && has_em) ? mis_w : 0.0f;
  radiance = radiance + throughput * em_val * add;
  active = active && !is_light;

  // --- NEE light sample: a direct, clipped index into the light rows ---
  const float r0 = pcg(rs);
  const float r1 = pcg(rs);
  const float r2 = pcg(rs);
  int pick = (int)(r0 * lc_f);
  pick = min(max(pick, 0), max(light_count - 1, 0));
  const float* L = lrows + (size_t)pick * kShadeK;
  const V3 lv0 = {__ldg(L + 0), __ldg(L + 1), __ldg(L + 2)};
  const V3 le1 = {__ldg(L + 3), __ldg(L + 4), __ldg(L + 5)};
  const V3 le2 = {__ldg(L + 6), __ldg(L + 7), __ldg(L + 8)};
  V3 Lc = {__ldg(L + 24), __ldg(L + 25), __ldg(L + 26)};
  const float sqrt_r1 = sqrtf(r1);
  const float lu = 1.0f - sqrt_r1;
  const float lv = r2 * sqrt_r1;
  if constexpr (kTextured) {
    // The light's base colour at level 1. Its barycentric order is
    // uv0 * u + uv1 * v + uv2 * w, not the hit's.
    const int light_tex = (int)__ldg(L + 31);
    if (light_tex >= 0) {
      const float lv_rn = __fmul_rn(r2, sqrt_r1);
      const float lw_rn = __fsub_rn(__fsub_rn(1.0f, lu), lv_rn);
      const float lt_u = bary_rn(__ldg(L + 18), lu, __ldg(L + 20), lv_rn,
                                 __ldg(L + 22), lw_rn);
      const float lt_v = bary_rn(__ldg(L + 19), lu, __ldg(L + 21), lv_rn,
                                 __ldg(L + 23), lw_rn);
      Lc = Lc * sample_tex(tex1, light_tex, lt_u, lt_v);
    }
  }
  const V3 lpnt = lv0 + le1 * lv + le2 * (1.0f - lu - lv);
  const V3 lcr = cross(le1, le2);
  const V3 ln_raw = normalize(lcr);
  const float larea = length(lcr) * 0.5f;
  const V3 l_dir = lpnt - hit_p;
  const float dist_sq = dot(l_dir, l_dir);
  const float ldist = sqrtf(dist_sq);
  const V3 ldir = l_dir * (1.0f / fmaxf(ldist, 1e-20f));
  const float cos_theta_l = fmaxf(dot(ln_raw, -ldir), 0.0f);
  float lpdf = dist_sq / fmaxf(cos_theta_l * larea, 1e-20f) / lc_f;
  const bool lvalid = light_count > 0 && cos_theta_l >= 1e-6f && larea > 0.0f;
  lpdf = lvalid ? lpdf : 0.0f;

  const bool nee_lane = active && mat != 2.0f && lpdf > 0.0f;
  const float eps = offset_eps(hit_p);
  const float end_eps = fmaxf(eps, offset_eps(hit_p + ldir * ldist));
  const float n_dot_l = fmaxf(dot(normal, ldir), 0.0f);
  const bool is_diff = mat == 0.0f;
  V3 bsdf_val;
  float bsdf_pdf;
  if (is_diff) {
    bsdf_val = albedo * kInvPi;
    bsdf_pdf = n_dot_l / kPi;
  } else {
    bsdf_val = eval_ggx(normal, -rd, ldir, roughness, f0);
    bsdf_pdf = ggx_pdf(normal, -rd, ldir, roughness);
  }
  const float wgt =
      (nee_lane && bsdf_pdf > 0.0f)
          ? power_heuristic(lpdf, bsdf_pdf) * n_dot_l / fmaxf(lpdf, 1e-20f)
          : 0.0f;
  const V3 new_pending = throughput * bsdf_val * Lc * wgt;

  // --- BSDF sampling ---
  const float s1 = pcg(rs);
  const float s2 = pcg(rs);
  const bool is_m = mat == 1.0f;
  const bool is_g = mat == 2.0f;
  Scatter sc;
  if (is_g) {
    sc = sample_dielectric(rd, normal, ior, albedo, s1);
  } else if (is_m) {
    sc = sample_ggx(normal, -rd, roughness, f0, s1, s2);
  } else {
    sc = sample_diffuse(normal, albedo, s1, s2);
  }
  const V3 dirn = sc.dir;
  const bool bad = mat != 2.0f && dot(dirn, geom_n) <= 0.0f;
  const float pdf = bad ? 0.0f : sc.pdf;
  const V3 tp = sc.throughput * (bad ? 0.0f : 1.0f);

  const bool active2 = active && pdf > 0.0f && length(tp) > 0.0f;
  const V3 throughput2 = active2 ? throughput * tp : throughput;
  const V3 off_n = dot(dirn, geom_n) > 0.0f ? geom_n : -geom_n;
  const V3 ro_next = active2 ? hit_p + off_n * eps : ro;
  const V3 rd_next = active2 ? dirn : rd;
  const float prev_pdf2 = active2 ? pdf : prev_pdf;
  const bool spec2 = active2 ? sc.specular : specular_bounce;

  // --- Russian roulette after depth 3 ---
  const float rr = pcg(rs);
  const float p = fmaxf(throughput2.x, fmaxf(throughput2.y, throughput2.z));
  const bool do_rr = active2 && depth > 3;
  const bool active3 = active2 && !(do_rr && rr > p);
  const float scale = (do_rr && rr <= p) ? 1.0f / fmaxf(p, 1e-20f) : 1.0f;
  const V3 throughput3 = throughput2 * scale;

  const bool not_last = depth < max_depth - 1;
  const bool do_next = active3 && not_last;
  const bool active_out = not_last ? do_next : active3;

  const V3 sro = hit_p + geom_n * eps;
  const float s_tmax = nee_lane ? ldist - 2.0f * end_eps : 0.0f;

  const float o[kNsOut] = {
      active_out ? 1.0f : 0.0f, ro_next.x, ro_next.y, ro_next.z,
      rd_next.x, rd_next.y, rd_next.z,
      throughput3.x, throughput3.y, throughput3.z,
      radiance.x, radiance.y, radiance.z,
      prev_pdf2, spec2 ? 1.0f : 0.0f,
      nee_lane ? 1.0f : 0.0f,
      new_pending.x, new_pending.y, new_pending.z,
      sro.x, sro.y, sro.z,
      ldir.x, ldir.y, ldir.z,
      s_tmax, do_next ? 1.0f : 0.0f};
#pragma unroll
  for (int r = 0; r < kNsOut; ++r) out[r * N + lane] = o[r];
  rng_out[lane] = (long long)rs;

  const size_t N2 = 2 * N;
  const float shadow_lane[8] = {ldir.x, ldir.y, ldir.z, sro.x, sro.y, sro.z,
                                s_tmax, 0.0f};
  const float next_lane[8] = {rd_next.x, rd_next.y, rd_next.z,
                              ro_next.x, ro_next.y, ro_next.z,
                              do_next ? kTMax : 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    rays8[r * N2 + lane] = shadow_lane[r];
    rays8[r * N2 + N + lane] = next_lane[r];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int wrt_shade_rows(const float* state, const long long* rng,
                              const float* rowT, const int* idx,
                              const float* light_rows, int light_count,
                              int depth, int max_depth, int n, float* out,
                              long long* rng_out, float* rays8,
                              void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    shade_rows_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        state, rng, rowT, idx, light_rows, light_count, depth, max_depth, n,
        TexLevel{}, TexLevel{}, out, rng_out, rays8);
  }
  return (int)cudaGetLastError();
}

// The textured instantiation: level 0 and level 1 (the same table where
// the pyramid has one level) as (N, 4) int32 quad rows, 16-byte aligned,
// with their (K, TH, TW).
extern "C" int wrt_shade_rows_textured(
    const float* state, const long long* rng, const float* rowT,
    const int* idx, const float* light_rows, int light_count, int depth,
    int max_depth, int n, const void* quads0, int k0, int th0, int tw0,
    const void* quads1, int k1, int th1, int tw1, float* out,
    long long* rng_out, float* rays8, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    shade_rows_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        state, rng, rowT, idx, light_rows, light_count, depth, max_depth, n,
        TexLevel{(const int4*)quads0, k0, th0, tw0},
        TexLevel{(const int4*)quads1, k1, th1, tw1}, out, rng_out, rays8);
  }
  return (int)cudaGetLastError();
}
