// Device helpers shared by the shade kernels: shade_rows.cu (the dense
// row-state bounce) and bvh_shade.cu (the BVH bounce). 3-vectors, the PCG
// draw, the power heuristic, the ray-origin offset, reflect / refract, the
// orthonormal basis, GGX's D and G terms, Lambert sampling and Schlick's
// dielectric reflectance: the functions whose plain versions are the same
// in ops/bsdf_v3.py (dense) and ops/bsdf.py (BVH). What the two paths write
// differently (normalize: a reciprocal product there, a quotient here; the
// Fresnel blend; the GGX value's order of products) stays in each kernel.
// Each source is compiled with its own flags, so the same helper may be
// contracted into FMAs in one kernel and not in the other.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wrt {

constexpr double kPiD = 3.141592653589793;
// Python folds these constants in double and rounds them to f32 once.
constexpr float kPi = (float)kPiD;
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kInvPi = (float)(1.0 / kPiD);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator+(V3 a, float s) {
  return {a.x + s, a.y + s, a.z + s};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;  // XLA's integer_pow: x * ((x*x) * (x*x))
  return x * (x2 * x2);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// One PCG-RXS-M-XS draw (ops/rng.py); the f32 draw is word / 2^32.
__device__ __forceinline__ float pcg(uint32_t& state) {
  const uint32_t old = state;
  state = old * 747796405u + 2891336453u;
  uint32_t word = (state >> ((old >> 28) + 4u)) ^ state;
  word = (word >> 22) ^ word;
  return __uint2float_rn(word) * 2.3283064365386963e-10f;
}

__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  const float b2 = b * b;
  return a2 / fmaxf(a2 + b2, 1e-20f);
}

__device__ __forceinline__ float offset_eps(V3 p) {
  const float m = fmaxf(fabsf(p.x), fmaxf(fabsf(p.y), fabsf(p.z)));
  return 1e-4f * fmaxf(1.0f, m);
}

__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  return i - n * (2.0f * dot(n, i));
}

__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta) {
  const float cos_i = dot(n, i);
  const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const V3 out = i * eta - n * (eta * cos_i + sqrtf(fmaxf(k, 0.0f)));
  return k >= 0.0f ? out : V3{0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ void build_onb(V3 n, V3& u, V3& v) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  u = {1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  v = {b, sign + n.y * n.y * a, -n.y};
}

__device__ __forceinline__ V3 local_to_world(V3 u, V3 v, V3 w, V3 a) {
  return u * a.x + v * a.y + w * a.z;
}

__device__ __forceinline__ float ggx_d(float n_dot_h, float a2) {
  const float d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0f;
  return a2 / (kPi * d * d);
}

__device__ __forceinline__ float ggx_g(float n_dot_v, float n_dot_l,
                                       float a2) {
  const float g1v = 2.0f * n_dot_v /
                    (n_dot_v + sqrtf(a2 + (1.0f - a2) * (n_dot_v * n_dot_v)));
  const float g1l = 2.0f * n_dot_l /
                    (n_dot_l + sqrtf(a2 + (1.0f - a2) * (n_dot_l * n_dot_l)));
  return g1v * g1l;
}

// torch's integer modulo takes the divisor's sign: -1 wraps to m - 1.
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

struct Scatter {
  V3 dir;
  float pdf;
  V3 throughput;
  bool specular;
};

__device__ __forceinline__ Scatter sample_diffuse(V3 normal, V3 albedo,
                                                  float r1, float r2) {
  V3 u, v;
  build_onb(normal, u, v);
  const float phi = kTwoPi * r1;
  const float cos_theta = sqrtf(fmaxf(1.0f - r2, 0.0f));
  const float sin_theta = sqrtf(fmaxf(r2, 0.0f));
  const V3 local = {cosf(phi) * sin_theta, sinf(phi) * sin_theta, cos_theta};
  const V3 d = local_to_world(u, v, normal, local);
  return {d, fmaxf(dot(normal, d), 0.0f) / kPi, albedo, false};
}

__device__ __forceinline__ float reflectance_dielectric(float cosine,
                                                        float ref_idx) {
  float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
  r0 = r0 * r0;
  return r0 + (1.0f - r0) * pow5(clamp01(1.0f - cosine));
}

}  // namespace wrt
