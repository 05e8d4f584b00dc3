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
//   scene    BvhScene: tri_v (T, 3) i32, base_color (T, 3), mat (T,) i32,
//            mrir (T, 3), tex (T, 4) i32, emissive (T, 3), pos / nrm (V, 3),
//            uv (V, 2), inst_tf / inst_inv (I, 4, 4), lights (L, 2) i32
//            [instance, triangle], the texture table; f32 unless said
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
// disagreement left.
//
// What bounds it on an H100: memory traffic and dependent gathers. A lane
// reads 102 bytes of its own (13 state floats, rng, ro, rd, tri, inst, the
// two masks) and writes 138; a found lane also gathers its triangle's rows
// (indices, three vertices' positions, normals and uvs, material), its
// instance's two matrices, the picked light's triangle and instance, and up
// to five texel quads, each a random 4-64 byte read that the L2 serves when
// the scene fits it (cornell: kilobytes; spheres: 257k triangles, ~40 MB of
// tables). The design is the simple one: one thread a lane, every
// intermediate in registers, the branch of the lane's material taken alone
// (the plain version computes all three and selects).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_math.cuh"

// The scene tables (ops/bvh_shade.py::_Scene). At file scope, not in the
// unnamed namespace: a type of internal linkage in its signature would give
// the extern "C" entry point internal linkage too.
struct BvhScene {
  const int* tri_v;
  const float* base_color;
  const int* mat;
  const float* mrir;
  const int* tex;
  const float* emissive;
  const float* pos;
  const float* nrm;
  const float* uv;
  const float* inst_tf;
  const float* inst_inv;
  const int* lights;
  const void* textures;
  int n_tri, n_inst, light_count, tex_k, tex_h, tex_w;
};

namespace {

using namespace wrt;

constexpr int kThreads = 256;
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

__device__ __forceinline__ V3 row3(const float* t, int i) {
  return {__ldg(t + 3 * i), __ldg(t + 3 * i + 1), __ldg(t + 3 * i + 2)};
}

__device__ __forceinline__ V3 lane3(const float* t, int lane) {
  return {t[3 * lane], t[3 * lane + 1], t[3 * lane + 2]};
}

__device__ __forceinline__ void store3(float* t, int lane, V3 v) {
  t[3 * lane] = v.x;
  t[3 * lane + 1] = v.y;
  t[3 * lane + 2] = v.z;
}

// Row i of a 4x4 matrix applied to a point: its dot product left to right,
// then the translation (ops/intersect.py::instance_ray, _light_tri_world).
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

// ops/trace.py::_inv_transpose_dir: normalize((n, 0) * inv).
__device__ __forceinline__ V3 inv_transpose_dir(const float* m, V3 n) {
  auto col = [&](int j) {
    return n.x * __ldg(m + j) + n.y * __ldg(m + 4 + j) +
           n.z * __ldg(m + 8 + j);
  };
  return normalize(V3{col(0), col(1), col(2)});
}

// A triangle's vertex indices and its world-space corners under an
// instance's transform (ops/trace.py::_light_tri_world).
struct WorldTri {
  int i0, i1, i2;
  V3 v0, v1, v2;
};

__device__ __forceinline__ WorldTri world_tri(const BvhScene& s, int tri,
                                              int inst) {
  const int t = clamp_index(tri, s.n_tri);
  const float* m = s.inst_tf + 16 * clamp_index(inst, s.n_inst);
  WorldTri w;
  w.i0 = __ldg(s.tri_v + 3 * t);
  w.i1 = __ldg(s.tri_v + 3 * t + 1);
  w.i2 = __ldg(s.tri_v + 3 * t + 2);
  w.v0 = xf_point(m, row3(s.pos, w.i0));
  w.v1 = xf_point(m, row3(s.pos, w.i1));
  w.v2 = xf_point(m, row3(s.pos, w.i2));
  return w;
}

// A barycentric blend of the three vertices' texture coordinates, a * uv0 +
// b * uv1 + c * uv2 per component.
__device__ __forceinline__ void blend_uv(const BvhScene& s, int i0, int i1,
                                         int i2, float a, float b, float c,
                                         float& u, float& v) {
  const float* t = s.uv;
  u = __ldg(t + 2 * i0) * a + __ldg(t + 2 * i1) * b + __ldg(t + 2 * i2) * c;
  v = __ldg(t + 2 * i0 + 1) * a + __ldg(t + 2 * i1 + 1) * b +
      __ldg(t + 2 * i2 + 1) * c;
}

__device__ __forceinline__ V3 corner(int word) {
  const float s = (float)(1.0 / 255.0);
  return {(float)((word >> 16) & 0xFF) * s, (float)((word >> 8) & 0xFF) * s,
          (float)(word & 0xFF) * s};
}

// ops/trace.py::sample_texture for one lane: white where tex < 0; the
// placeholder's texel, or a bilinear level-0 sample with repeat wrap.
template <bool kTextured>
__device__ __forceinline__ V3 sample_texture(const BvhScene& s, int tex,
                                             float uu, float vv) {
  if (tex < 0) return {1.0f, 1.0f, 1.0f};
  if constexpr (!kTextured) {
    const float* t = (const float*)s.textures;
    return {__ldg(t), __ldg(t + 1), __ldg(t + 2)};
  } else {
    const int layer = min(tex, s.tex_k - 1);
    const float fx = (uu - floorf(uu)) * (float)s.tex_w - 0.5f;
    const float fy = (vv - floorf(vv)) * (float)s.tex_h - 0.5f;
    const int x0 = (int)floorf(fx);
    const int y0 = (int)floorf(fy);
    const int row = (layer * s.tex_h + floor_mod(y0, s.tex_h)) * s.tex_w +
                    floor_mod(x0, s.tex_w);
    const int4 q = __ldg((const int4*)s.textures + row);
    const float wx = fx - (float)x0;
    const float wy = fy - (float)y0;
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

template <bool kTextured>
__global__ void __launch_bounds__(kThreads)
bvh_shade_kernel(BvhScene s, const float* __restrict__ state,
                 const long long* __restrict__ rng,
                 const float* __restrict__ ro_in,
                 const float* __restrict__ rd_in,
                 const bool* __restrict__ active,
                 const int* __restrict__ tri_in,
                 const int* __restrict__ inst_in,
                 const bool* __restrict__ occluded, int depth, int max_depth,
                 int n, float* __restrict__ out,
                 long long* __restrict__ rng_out,
                 float* __restrict__ ro_next, float* __restrict__ rd_next,
                 bool* __restrict__ do_next_out, float* __restrict__ sro_out,
                 float* __restrict__ srd_out, float* __restrict__ s_tmax_out,
                 bool* __restrict__ nee_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t N = (size_t)n;
  auto S = [&](int r) { return state[r * N + lane]; };
  V3 throughput = {S(0), S(1), S(2)};
  V3 radiance = {S(3), S(4), S(5)};
  float prev_pdf = S(6);
  bool specular = S(7) > 0.5f;
  const V3 pending = {S(8), S(9), S(10)};
  const bool take = S(11) > 0.5f && !(occluded != nullptr && occluded[lane]);
  float lane_rays = S(12);
  uint32_t rs = (uint32_t)rng[lane];
  const V3 zero = {0.0f, 0.0f, 0.0f};

  // --- the previous bounce's NEE, with the last shadow walk's verdict ---
  radiance = radiance + (take ? pending : zero);

  const int inst = inst_in[lane];
  const bool found = inst >= 0 && (active == nullptr || active[lane]);
  V3 new_pending = zero, ro_n = zero, rd_n = zero, sro = zero, srd = zero;
  float s_tmax = 0.0f;
  bool pend = false, nee_lane = false, do_next = false;
  if (!found) {
    for (int k = 0; k < 6; ++k) pcg(rs);
  } else {
    const V3 ro = lane3(ro_in, lane);
    const V3 rd = lane3(rd_in, lane);
    const int tri = tri_in[lane];
    const int tc = clamp_index(tri, s.n_tri);
    const float* inv = s.inst_inv + 16 * clamp_index(inst, s.n_inst);

    // --- load_hit ---
    const V3 lro = xf_point(inv, ro);
    const V3 lrd = xf_dir(inv, rd);
    const int i0 = __ldg(s.tri_v + 3 * tc), i1 = __ldg(s.tri_v + 3 * tc + 1),
              i2 = __ldg(s.tri_v + 3 * tc + 2);
    const V3 v0 = row3(s.pos, i0);
    const V3 e1 = row3(s.pos, i1) - v0;
    const V3 e2 = row3(s.pos, i2) - v0;
    const V3 sv = lro - v0;
    const V3 h = cross(lrd, e2);
    const float f = 1.0f / dot(e1, h);
    const float u = f * dot(sv, h);
    const V3 q = cross(sv, e1);
    const float v = f * dot(lrd, q);
    const float w = 1.0f - u - v;
    const float hit_t = f * dot(e2, q);
    float tex_u, tex_v;
    blend_uv(s, i0, i1, i2, w, u, v, tex_u, tex_v);
    const V3 ln = normalize(row3(s.nrm, i0) * w + row3(s.nrm, i1) * u +
                            row3(s.nrm, i2) * v);
    const int t_base = __ldg(s.tex + 4 * tc), t_mr = __ldg(s.tex + 4 * tc + 1),
              t_nrm = __ldg(s.tex + 4 * tc + 2),
              t_em = __ldg(s.tex + 4 * tc + 3);
    const V3 albedo = row3(s.base_color, tc) *
                      sample_texture<kTextured>(s, t_base, tex_u, tex_v);
    V3 ln_final = ln;
    if (t_nrm >= 0) {
      // Tangent-space normal mapping with the edge-1 tangent.
      const V3 m = sample_texture<kTextured>(s, t_nrm, tex_u, tex_v);
      const V3 n_map = {m.x * 2.0f - 1.0f, m.y * 2.0f - 1.0f,
                        m.z * 2.0f - 1.0f};
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

    const int mat = __ldg(s.mat + tc);
    const V3 mrir = row3(s.mrir, tc);
    float metallic = mrir.x, rough = mrir.y;
    if (t_mr >= 0) {
      const V3 mr = sample_texture<kTextured>(s, t_mr, tex_u, tex_v);
      metallic = mrir.x * mr.z;
      rough = mrir.y * mr.y;
    }
    const float roughness = fmaxf(rough, 0.005f);
    V3 emissive = row3(s.emissive, tc);
    if (t_em >= 0) {
      emissive = emissive * sample_texture<kTextured>(s, t_em, tex_u, tex_v);
    }
    const V3 f0 = {(albedo.x - 0.04f) * metallic + 0.04f,
                   (albedo.y - 0.04f) * metallic + 0.04f,
                   (albedo.z - 0.04f) * metallic + 0.04f};

    // --- emissive / light hit with MIS ---
    const bool is_light = mat == 3;
    const bool has_em = is_light || length(emissive) > 1e-4f;
    const V3 em_val = is_light ? albedo : emissive;
    const float lc_f = (float)max(s.light_count, 1);
    const WorldTri ht = world_tri(s, tri, inst);
    const V3 hcr = cross(ht.v1 - ht.v0, ht.v2 - ht.v0);
    const float harea = length(hcr) * 0.5f;
    const float cos_tl = fmaxf(dot(normalize(hcr), -rd), 0.0f);
    float light_pdf = (hit_t * hit_t) / fmaxf(cos_tl * harea, 1e-20f) / lc_f;
    light_pdf = cos_tl >= 1e-4f ? light_pdf : 0.0f;
    const float mis_w =
        specular ? 1.0f : power_heuristic(prev_pdf, light_pdf);
    radiance = radiance + (has_em ? throughput * em_val * mis_w : zero);
    bool live = !is_light;

    // --- NEE: a light triangle, a point on it, the shadow ray ---
    const float r0 = pcg(rs);
    const float r1 = pcg(rs);
    const float r2 = pcg(rs);
    const int pick = min(max((int)(r0 * lc_f), 0), max(s.light_count - 1, 0));
    const int l_inst = __ldg(s.lights + 2 * pick);
    const int l_tri = __ldg(s.lights + 2 * pick + 1);
    const WorldTri lt = world_tri(s, l_tri, l_inst);
    const float sqrt_r1 = sqrtf(r1);
    const float lu = 1.0f - sqrt_r1;
    const float lv = r2 * sqrt_r1;
    const float lw = 1.0f - lu - lv;
    const V3 lpnt = lt.v0 * lu + lt.v1 * lv + lt.v2 * lw;
    const V3 lcr = cross(lt.v1 - lt.v0, lt.v2 - lt.v0);
    const V3 ln_raw = normalize(lcr);
    const float larea = length(lcr) * 0.5f;
    const V3 l_dir = lpnt - hit_p;
    const float dist_sq = dot(l_dir, l_dir);
    const float ldist = sqrtf(dist_sq);
    const V3 ldir = l_dir / fmaxf(ldist, 1e-20f);
    const float cos_theta_l = fmaxf(dot(ln_raw, -ldir), 0.0f);
    const int ltc = clamp_index(l_tri, s.n_tri);
    float lt_u, lt_v;
    blend_uv(s, lt.i0, lt.i1, lt.i2, lu, lv, lw, lt_u, lt_v);
    const V3 L = row3(s.base_color, ltc) *
                 sample_texture<kTextured>(s, __ldg(s.tex + 4 * ltc), lt_u,
                                           lt_v);
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
    const float s1 = pcg(rs);
    const float s2 = pcg(rs);
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
    const float rr = pcg(rs);
    const float p = fmaxf(throughput.x, fmaxf(throughput.y, throughput.z));
    const bool do_rr = live && depth > 3;
    live = live && !(do_rr && rr > p);
    if (do_rr && rr <= p) throughput = throughput / fmaxf(p, 1e-20f);
    do_next = live && depth < max_depth - 1;
    if (do_next) {
      ro_n = hit_p + off_n * eps;
      rd_n = sc.dir;
    }
    lane_rays = lane_rays + (nee_lane ? 1.0f : 0.0f) + (do_next ? 1.0f : 0.0f);
  }

  const float o[kNs] = {throughput.x, throughput.y, throughput.z,
                        radiance.x, radiance.y, radiance.z,
                        prev_pdf, specular ? 1.0f : 0.0f,
                        new_pending.x, new_pending.y, new_pending.z,
                        pend ? 1.0f : 0.0f, lane_rays};
#pragma unroll
  for (int r = 0; r < kNs; ++r) out[r * N + lane] = o[r];
  rng_out[lane] = (long long)rs;
  store3(ro_next, lane, ro_n);
  store3(rd_next, lane, rd_n);
  do_next_out[lane] = do_next;
  store3(sro_out, lane, sro);
  store3(srd_out, lane, srd);
  s_tmax_out[lane] = s_tmax;
  nee_out[lane] = nee_lane;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). `scene` is a
// host pointer, copied into the launch; textured != 0 takes the quad-table
// instantiation (the table 16-byte aligned).
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
