// Row fetches by index: transposed shade rows, and texel quad words.
//
// wrt_fetch_rows_t replaces webgpu_raytracer_tpu/ops/pallas_dense.py::
// _fetch_kernel (launched by pallas_fetch_t): out (K, R) = table[clip(idx)].T
// for a (N, K) f32 table, idx clipped to [0, N - 1]. It serves the G-buffer
// seeding of bounce 0 (the shade table, N = padded world triangles) and the
// NEE light rows of every bounce of the textured path.
//
// wrt_fetch_quad replaces webgpu_raytracer_tpu/ops/pallas_dense.py::
// _kron_kernel (launched by pallas_fetch_kron): out (R, 4) = flat[clip(rows)]
// for the (N, 4) packed bilinear quad words of a texture level. The same
// kernel serves level 0 (bounce 0, the G-buffer) and the 128^2 mip
// (bounces >= 1); the two levels differ only in the table they read. The
// mip rule stays in build_quad_pyramid.
//
// On the TPU both are matmuls (a one-hot, and a Kronecker-factored one-hot
// against bf16x3 planes) because the TPU gathers slowly. On an H100 they
// are gathers, and both copy bits: the output is bit-equal to the plain
// PyTorch versions in webgpu_raytracer_tpu_torch/ops/fetch.py.
//
// What bounds them on an H100: bytes. The row fetch at cornell 1080p
// seeding (R = 2,073,600, K = 40) writes 332 MB and reads 8 MB of indices,
// ~101 us at 3.35 TB/s; the table (tens of KB) stays in L2. The quad fetch
// at 1080p reads 8 MB of rows and writes 33 MB, plus the table once (0.26 MB
// mip, 16.8 MB level 0), ~12-17 us. The design does one pass with coalesced
// stores and no one-hot: in the row fetch one thread owns one lane and a
// group of kColGroup columns, lanes fastest within a warp, so each of its
// stores is part of a 128-byte warp-wide store into one row of the (K, R)
// output; in the quad fetch one thread does one 16-byte load and one
// 16-byte store. Values move as 32-bit words, never through float
// arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColGroup = 8;  // columns of one row copied by one thread

__device__ __forceinline__ int clip_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
fetch_rows_t_kernel(const unsigned int* __restrict__ table, int n, int k,
                    const int* __restrict__ idx, int r,
                    unsigned int* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= r) return;
  const int c0 = blockIdx.y * kColGroup;
  const int c1 = min(c0 + kColGroup, k);
  const unsigned int* row =
      table + static_cast<long long>(clip_index(__ldg(idx + lane), n)) * k;
  for (int c = c0; c < c1; ++c) {
    out[static_cast<long long>(c) * r + lane] = __ldg(row + c);
  }
}

__global__ void __launch_bounds__(kThreads)
fetch_quad_kernel(const int4* __restrict__ flat, int n,
                  const int* __restrict__ rows, int r,
                  int4* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= r) return;
  out[lane] = __ldg(flat + clip_index(__ldg(rows + lane), n));
}

}  // namespace

// table (n, k) f32 as bits, idx (r,) i32 -> out (k, r). n, k, r >= 1.
extern "C" int wrt_fetch_rows_t(const void* table, int n, int k,
                                const int* idx, int r, void* out,
                                cudaStream_t stream) {
  dim3 grid((r + kThreads - 1) / kThreads, (k + kColGroup - 1) / kColGroup);
  fetch_rows_t_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const unsigned int*>(table), n, k, idx, r,
      static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// flat (n, 4) i32, 16-byte aligned, rows (r,) i32 -> out (r, 4). n, r >= 1.
extern "C" int wrt_fetch_quad(const void* flat, int n, const int* rows, int r,
                              void* out, cudaStream_t stream) {
  const int blocks = (r + kThreads - 1) / kThreads;
  fetch_quad_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int4*>(flat), n, rows, r, static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
