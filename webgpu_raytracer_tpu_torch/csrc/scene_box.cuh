// The scene box and a lane's slab interval of it, shared by cluster_cull.cu
// and scan_sweep.cu: what caps a lane's interval at the scene's far side.
//
// The box is that of the live tile spheres (r >= 0): min of c - r, max of
// c + r per axis. A lane's (t_enter, t_exit) come from the three slabs, a
// direction component below 1e-20 in magnitude counting as +-1e-20. Every
// difference and quotient is a separately rounded f32 operation in the
// order of webgpu_raytracer_tpu_torch/ops/cluster_cull.py::box_interval
// (min and max are exact in any order), so the kernels and the plain
// versions agree bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "tri_tile.cuh"

namespace wrt {

constexpr float kBig = 3e38f;

struct BoxScratch {
  float part[2][3][32];  // per-warp partial lo / hi
};

// The box of the live spheres, reduced over the block: every thread calls
// it and gets lo[3], hi[3]. Synchronises the block.
__device__ __forceinline__ void block_scene_box(const float4* __restrict__
                                                    spheres,
                                                int ct, BoxScratch& scratch,
                                                float* lo, float* hi) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int a = 0; a < 3; ++a) {
    lo[a] = kBig;
    hi[a] = -kBig;
  }
  for (int c = threadIdx.x; c < ct; c += blockDim.x) {
    const float4 s = spheres[c];
    if (s.w >= 0.f) {
      const float cs[3] = {s.x, s.y, s.z};
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], sub(cs[a], s.w));
        hi[a] = fmaxf(hi[a], add(cs[a], s.w));
      }
    }
  }
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
    if (wl == 0) {
      scratch.part[0][a][warp] = lo[a];
      scratch.part[1][a][warp] = hi[a];
    }
  }
  __syncthreads();
  for (int a = 0; a < 3; ++a) {
    lo[a] = scratch.part[0][a][0];
    hi[a] = scratch.part[1][a][0];
    for (int w = 1; w < n_warps; ++w) {
      lo[a] = fminf(lo[a], scratch.part[0][a][w]);
      hi[a] = fmaxf(hi[a], scratch.part[1][a][w]);
    }
  }
}

// The slab interval of the ray r = [d, o, ...] against the box.
__device__ __forceinline__ void slab_interval(const float* r, const float* lo,
                                              const float* hi, float& t_enter,
                                              float& t_exit) {
  for (int a = 0; a < 3; ++a) {
    const float d = r[a], o = r[3 + a];
    const float d_safe =
        fabsf(d) > 1e-20f ? d : (d >= 0.f ? 1e-20f : -1e-20f);
    const float t1 = __fdiv_rn(sub(lo[a], o), d_safe);
    const float t2 = __fdiv_rn(sub(hi[a], o), d_safe);
    const float far = fmaxf(t1, t2), near = fminf(t1, t2);
    t_exit = a == 0 ? far : fminf(t_exit, far);
    t_enter = a == 0 ? near : fmaxf(t_enter, near);
  }
}

}  // namespace wrt
