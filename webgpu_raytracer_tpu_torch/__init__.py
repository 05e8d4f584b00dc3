"""webgpu_raytracer_tpu_torch: the path tracer on PyTorch and CUDA.

A port of the JAX package `webgpu_raytracer_tpu` (its reference, kept
beside it) to an NVIDIA H100: the same scenes through the shared C++ scene
compiler, the same world-triangle tables, estimator and PCG streams, with
the TPU's Pallas kernels rewritten as hand-written CUDA (`csrc/`). Every
kernel has a plain PyTorch version beside it, which runs on the CPU.
This package never imports JAX.
"""

from .config import RenderConfig
from .models.native import NativeWorld
from .render.renderer import Renderer

__all__ = ["RenderConfig", "NativeWorld", "Renderer"]
