// The present step's post-process chain in two passes: mean radiance and
// firefly clamp, then un-jitter, bilateral, TAA, ACES, sharpen and gamma.
//
// Replaces the plain PyTorch chain of ops/postprocess.py::postprocess (the
// port of the JAX package's plain-jnp ops/postprocess.py, which has no Pallas
// kernel), whose ~180 elementwise and gather kernels each made a pass over
// the image. It computes the same function in the same order of f32
// operations, and the plain chain stays the CPU path and the yardstick the
// kernels are held to bit for bit on the card.
//
//   present_clean_kernel  acc (H, W, 4) f32 sums and counts -> clean
//                         (H, W, 4) f32 (the fourth word unused): the mean
//                         radiance clamped to 3x its 3x3 edge-clamped
//                         neighbourhood max + 0.1.
//   present_tone_kernel   clean -> ldr (H, W, 3) u8 and the new TAA history,
//                         written over history (H, W, 3) f32 in place (a
//                         pixel reads only its own history). u is clean, or
//                         on the un-jitter graph while the device's frame
//                         count is at most 16 the bilinear resample of clean
//                         at the pixel less the average jitter; then the 3x3
//                         bilateral of u with its moments, TAA against the
//                         neighbourhood mean +- k sigma, ACES, sharpen,
//                         gamma and the 8-bit quantisation.
//
// A pixel's 3x3 bilateral reads u at its edge-clamped neighbours, each of
// which is clean's own 3x3 clamp (a 5x5 footprint of radiance, and more on
// the resample's shifted taps); the first pass writes clean once so the
// second reads its neighbours from L2 (a 720x480 clean is 5.5 MB, 1080p
// 33 MB, against a 50 MB L2). The frame count (int64) and the average
// jitter are read from the device, so a captured present replays with the
// values of its frame and never synchronises.
//
// Exactness. This file is compiled with --fmad=false (kernels.py): every
// product, sum and quotient is rounded on its own, as ATen's one-operation
// kernels round them, in the plain chain's order. The plain chain's Python
// scalars reach ATen as doubles cast to f32 (kF32 below); a division by a
// scalar is ATen's product with the scalar's f32 reciprocal (the wrapper
// passes 1/0.2 and 1/9 so computed); the 3-channel sum of torch.sum(...,
// dim=-1) is ATen's reduce order, (c0 + c2) + c1 (two lanes an output: lane
// 0 adds 0 and 2, lane 1 holds 1, then one shuffle adds them); maximum,
// minimum and clamp pass a NaN on as ATen's do; '/' and sqrtf are IEEE,
// expf and powf the precise versions ATen calls; the float to u8 cast goes
// through int64 as c10's does. The wrapper passes the spatial weights
// w_s as the plain chain computes them (numpy's f32 exp).
//
// What bounds it on an H100. Bytes would allow ~8 us at 720x480: ~75 a
// pixel (acc 16 read, the clean scratch 16 written and 16 read, history 12
// read and 12 written, the image 3), 25.9 MB at 3.35 TB/s; 1080p 155.5 MB,
// ~46 us. Instruction issue takes longer: a pixel of the tone pass runs 9
// precise expf, 9 IEEE quotients, 3 sqrtf and 3 precise powf (tens of
// instructions each) beside ~300 separately rounded operations, so the tone
// pass is ~70% of the time. The design: the clean pass computes each
// pixel's radiance once into shared memory (a block's 32x8 pixels and a
// one-pixel ring; 9 times a pixel from global memory took 12.7 us against
// 7.1 at 720x480), and the tone pass is instantiated once with and once
// without the resample, its 3x3 loop unrolled (18.5 -> 17.2 us; with the
// resample 32.5 -> 25.2). Measured at 720x480 (profiler, back to back,
// H100): clean 7.1 us, tone 17.2.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// A Python float as ATen applies it to an f32 tensor: the double rounded to
// f32 (not the decimal rounded to f32 directly, which can differ).
__host__ __device__ constexpr float kF32(double d) {
  return static_cast<float>(d);
}

// torch.maximum / torch.minimum: the first NaN operand is the result, else
// the card's max / min.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// get_radiance: where(a > 0, sum / clamp(a, min=1e-20), 0), a channel.
__device__ __forceinline__ void radiance(const float4& s, float out[3]) {
  const bool seen = s.w > 0.0f;
  const float a = clamp_min(s.w, kF32(1e-20));
  out[0] = seen ? s.x / a : 0.0f;
  out[1] = seen ? s.y / a : 0.0f;
  out[2] = seen ? s.z / a : 0.0f;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
present_clean_kernel(const float4* __restrict__ acc, int h, int w,
                     float4* __restrict__ clean) {
  // The radiance of the block's pixels and of a one-pixel ring around
  // them, each computed once (three IEEE quotients a pixel), at the
  // edge-clamped coordinates _edge_pad gathers.
  constexpr int kTileX = kBlockX + 2;
  constexpr int kTileY = kBlockY + 2;
  __shared__ float rad[kTileY][kTileX][3];
  const int x0 = blockIdx.x * kBlockX - 1;
  const int y0 = blockIdx.y * kBlockY - 1;
  for (int i = threadIdx.y * kBlockX + threadIdx.x; i < kTileX * kTileY;
       i += kBlockX * kBlockY) {
    const int ty = i / kTileX;
    const int tx = i - ty * kTileX;
    radiance(__ldg(acc + static_cast<long long>(clampi(y0 + ty, h)) * w +
                   clampi(x0 + tx, w)),
             rad[ty][tx]);
  }
  __syncthreads();
  const int x = x0 + 1 + threadIdx.x;
  const int y = y0 + 1 + threadIdx.y;
  if (x >= w || y >= h) return;
  // max_nb starts at -1e6 and takes the 8 neighbours in (dy, dx) order.
  float nb[3] = {kF32(-1e6), kF32(-1e6), kF32(-1e6)};
  for (int dy = 0; dy <= 2; ++dy) {
    for (int dx = 0; dx <= 2; ++dx) {
      if (dy == 1 && dx == 1) continue;
      const float* r = rad[threadIdx.y + dy][threadIdx.x + dx];
#pragma unroll
      for (int c = 0; c < 3; ++c) nb[c] = max_nan(nb[c], r[c]);
    }
  }
  const float* r = rad[threadIdx.y + 1][threadIdx.x + 1];
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float cap = nb[c] * kF32(3.0) + kF32(0.1);
    out[c] = min_nan(clamp_min(r[c], 0.0f), cap);
  }
  clean[static_cast<long long>(y) * w + x] =
      make_float4(out[0], out[1], out[2], 0.0f);
}

// The constants the wrapper computes as the plain chain does.
struct ToneArgs {
  float w_s[3];        // spatial weight by dx^2 + dy^2 = 0, 1, 2
  float inv_two_sr;    // f32(1) / f32(2 * sigma_r)
  float inv_nine;      // f32(1) / f32(9)
  float gamma;         // f32(1 / 2.2)
};

__device__ __forceinline__ void load3(const float4* clean, long long i,
                                      float out[3]) {
  const float4 v = __ldg(clean + i);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
}

// u at (y, x), a pixel of the image: clean, or its bilinear resample at
// (y, x) less the average jitter (unjittered_radiance, _bilinear_sample).
template <bool kResample>
__device__ __forceinline__ void load_u(const float4* clean, int h, int w,
                                       int y, int x, float jy, float jx,
                                       float out[3]) {
  if (!kResample) {
    load3(clean, static_cast<long long>(y) * w + x, out);
    return;
  }
  // fy = ys + 0.5 - jitter[1] * H - 0.5, left to right.
  const float fy = ((static_cast<float>(y) + 0.5f) - jy) - 0.5f;
  const float fx = ((static_cast<float>(x) + 0.5f) - jx) - 0.5f;
  const long long y0 = static_cast<long long>(floorf(fy));
  const long long x0 = static_cast<long long>(floorf(fx));
  const float wy = fy - static_cast<float>(y0);
  const float wx = fx - static_cast<float>(x0);
  const float omx = 1.0f - wx;
  const float omy = 1.0f - wy;
  auto idx = [&](long long yi, long long xi) {
    yi = yi < 0 ? 0 : (yi > h - 1 ? h - 1 : yi);
    xi = xi < 0 ? 0 : (xi > w - 1 ? w - 1 : xi);
    return yi * w + xi;
  };
  float c00[3], c10[3], c01[3], c11[3];
  load3(clean, idx(y0, x0), c00);
  load3(clean, idx(y0, x0 + 1), c10);
  load3(clean, idx(y0 + 1, x0), c01);
  load3(clean, idx(y0 + 1, x0 + 1), c11);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = c00[c] * omx + c10[c] * wx;
    const float bot = c01[c] * omx + c11[c] * wx;
    out[c] = top * omy + bot * wy;
  }
}

// aces(): clamp((x * (a x + b)) / (x * (c x + d) + e), 0, 1).
__device__ __forceinline__ float aces(float x) {
  const float num = x * (x * kF32(2.51) + kF32(0.03));
  const float den = x * (x * kF32(2.43) + kF32(0.59)) + kF32(0.14);
  return clamp_01(num / den);
}

// One pixel of the tone pass, u resampled or not.
template <bool kResample>
__device__ __forceinline__ void tone(const float4* clean, int h, int w,
                                     int y, int x, long long fc, float jy,
                                     float jx, const ToneArgs& k,
                                     float* history, unsigned char* ldr) {
  float u[3];
  load_u<kResample>(clean, h, w, y, x, jy, jx, u);

  // Bilateral 3x3 with the TAA moments, taps in (dy, dx) order.
  float filt[3] = {0.0f, 0.0f, 0.0f};
  float m1[3] = {0.0f, 0.0f, 0.0f};
  float m2[3] = {0.0f, 0.0f, 0.0f};
  float weight = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      float nb[3];
      load_u<kResample>(clean, h, w, clampi(y + dy, h), clampi(x + dx, w),
                        jy, jx, nb);
      float sq[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = nb[c] - u[c];
        sq[c] = d * d;
      }
      const float s = (sq[0] + sq[2]) + sq[1];
      const float w_r = expf((-s) * k.inv_two_sr);
      const float wt = w_r * k.w_s[dx * dx + dy * dy];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        filt[c] = filt[c] + nb[c] * wt;
        m1[c] = m1[c] + nb[c];
        m2[c] = m2[c] + nb[c] * nb[c];
      }
      weight = weight + wt;
    }
  }
  const float wsum = clamp_min(weight, kF32(1e-4));

  // TAA: clamp width and weight from the device's frame count.
  const float kk = fc > 16 ? kF32(60.0) : kF32(1.0);
  float alpha = clamp_min(1.0f / clamp_min(static_cast<float>(fc), 1.0f),
                          kF32(1e-4));
  if (fc == 1) alpha = kF32(0.1);

  const long long p = static_cast<long long>(y) * w + x;
  float* hist = history + 3 * p;
  unsigned char* out = ldr + 3 * p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float den = filt[c] / wsum;
    const float mean = m1[c] * k.inv_nine;
    const float var = clamp_min(m2[c] * k.inv_nine - mean * mean, 0.0f);
    const float sd = sqrtf(var) * kk;
    const float ch = min_nan(max_nan(hist[c], mean - sd), mean + sd);
    const float fin = ch + (den - ch) * alpha;
    const float sharp = aces(fin) + aces(u[c] - den) * kF32(0.3);
    const float g = powf(clamp_01(sharp), k.gamma);
    hist[c] = fin;
    out[c] = static_cast<unsigned char>(
        static_cast<long long>(g * kF32(255.0) + kF32(0.5)));
  }
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
present_tone_kernel(const float4* __restrict__ clean, int h, int w,
                    const long long* __restrict__ frame,
                    const float* __restrict__ avg_jitter, int unjitter,
                    ToneArgs k, float* __restrict__ history,
                    unsigned char* __restrict__ ldr) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const long long fc = __ldg(frame);
  if (unjitter != 0 && !(fc > 16)) {
    const float jy = __ldg(avg_jitter + 1) * static_cast<float>(h);
    const float jx = __ldg(avg_jitter + 0) * static_cast<float>(w);
    tone<true>(clean, h, w, y, x, fc, jy, jx, k, history, ldr);
  } else {
    tone<false>(clean, h, w, y, x, fc, 0.0f, 0.0f, k, history, ldr);
  }
}

}  // namespace

// acc (h, w, 4) f32, 16-byte aligned; clean (h, w, 4) f32 scratch; frame a
// 0-d int64; avg_jitter (2,) f32; history (h, w, 3) f32 in and out; ldr
// (h, w, 3) u8. Two launches on `stream`; h, w >= 1.
extern "C" int wrt_present(const void* acc, int h, int w, void* clean,
                           const long long* frame, const float* avg_jitter,
                           int unjitter, float w_s0, float w_s1, float w_s2,
                           float inv_two_sr, float inv_nine, float gamma,
                           float* history, unsigned char* ldr,
                           cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  present_clean_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float4*>(acc), h, w, static_cast<float4*>(clean));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const ToneArgs k{{w_s0, w_s1, w_s2}, inv_two_sr, inv_nine, gamma};
  present_tone_kernel<<<grid, block, 0, stream>>>(
      static_cast<const float4*>(clean), h, w, frame, avg_jitter, unjitter,
      k, history, ldr);
  return static_cast<int>(cudaGetLastError());
}
