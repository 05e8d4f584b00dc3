"""Backend dispatch: the dense sweep or the BVH walk.

The port of the JAX package's `ops/api.py`. Both backends give the same
estimator with the same per-(pixel, frame, sample) RNG streams. The rule is
the JAX package's: on the accelerator the dense path takes every scene (its
multi-tile narrow phase behind the cull carries large scenes); off it, the
dense path takes scenes up to DENSE_MAX_TRIS world triangles and the BVH
walk the larger ones, since the plain dense sweep's cost grows with rays x
triangles.
"""

from __future__ import annotations

import torch

from .dense_trace import trace_pixels_dense
from .trace import trace_pixels

DENSE_MAX_TRIS = 16384


def choose_backend(world_tri_count: int, device) -> str:
    """"dense" on CUDA; on the CPU "dense" up to DENSE_MAX_TRIS world
    triangles and "bvh" above."""
    if torch.device(device).type == "cuda":
        return "dense"
    return "dense" if world_tri_count <= DENSE_MAX_TRIS else "bvh"


def get_tracer(backend: str):
    """tracer(scene, camera, frame_count, jitter, width, height, spp,
    max_depth, **kwargs), the sharding offsets and with_stats among the
    keywords. For "dense" the scene is (WorldTables, textures), as the JAX
    package's is (WorldTris, textures); for "bvh" a DeviceScene."""
    if backend == "dense":
        def tracer(scene, *args, **kwargs):
            tables, textures = scene
            return trace_pixels_dense(tables, *args, textures=textures,
                                      **kwargs)
        return tracer
    if backend == "bvh":
        return trace_pixels
    raise ValueError(f"unknown backend {backend!r}")
