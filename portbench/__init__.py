"""The benchmark of webgpu_raytracer_tpu_torch on an NVIDIA H100."""
