"""Multi-card rendering: tile and sample sharding over a DeviceMesh.

The port of the JAX package's `parallel/sharding.py` on torch.distributed.
The pixel grid is split over ranks (`tile`: each renders its own row band
with the frame's pixel indices), or every rank renders the same pixels with
a disjoint slice of the sample streams and the per-rank means are summed
with an all-reduce (`sample`); the 2-D step does both over a ("tile",
"sample") mesh. The counter-based per-(pixel, sample) RNG (ops/rng.py)
makes the tile step bit-identical to one device, and the sample steps equal
to it up to the all-reduce's summation order.

A mesh is a `torch.distributed.device_mesh.DeviceMesh`; the caller starts
the process group (`init_process_group` with its own address, world size
and rank: NCCL across cards, gloo across CPU processes). A rank's
coordinate on a mesh dimension takes the place of `jax.lax.axis_index`,
and `all_reduce(SUM)` over that dimension's group the place of `psum`.

A step is called as step(scene, camera, frame_count, jitter, accum) on
every rank. The tile step and the 2-D step take and return the rank's own
row band of the (H*W, 4) accumulator, rows [row0, row0 + H / n) for its
tile coordinate; the sample step takes and returns the whole accumulator,
the same on every rank. `backend` ("bvh" by default, as in the JAX
package, or "dense") picks the tracer (`ops/api.get_tracer`); its scene is
a DeviceScene or (WorldTables, textures).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.api import get_tracer
from ..ops.trace import accumulate

AXIS = "shard"


def make_mesh(device_type: str = "cuda", shape=None,
              dim_names=(AXIS,)) -> DeviceMesh:
    """A mesh over every rank of the started process group: 1-D
    ("shard",) by default, or `shape` with `dim_names`, e.g. (2, 2) and
    ("tile", "sample")."""
    n = dist.get_world_size()
    ranks = torch.arange(n)
    if shape is not None:
        ranks = ranks.reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(dim_names))


def _all_reduce_sum(col: torch.Tensor, mesh: DeviceMesh, dim: str):
    dist.all_reduce(col, op=dist.ReduceOp.SUM, group=mesh.get_group(dim))
    return col


def tile_sharded_step(mesh: DeviceMesh, width: int, height: int, spp: int,
                      max_depth: int, backend: str = "bvh"):
    """Pixel rows split over the mesh; each rank traces its band with the
    frame's pixel indices, so the bands are the one-device frame."""
    n = mesh.size()
    assert height % n == 0, f"height {height} must divide over {n} devices"
    rows_per = height // n
    tracer = get_tracer(backend)
    dev = mesh.get_local_rank(AXIS)

    def step(scene, camera, frame_count, jitter, accum):
        col = tracer(scene, camera, frame_count, jitter, width, rows_per,
                     spp, max_depth, row0=dev * rows_per,
                     full_height=height)
        return accumulate(accum, col, frame_count)

    return step


def tile_sample_sharded_step(mesh: DeviceMesh, width: int, height: int,
                             spp_total: int, max_depth: int,
                             tile_axis: str = "tile",
                             sample_axis: str = "sample",
                             backend: str = "bvh"):
    """2-D mesh: rows split over `tile_axis`, sample streams over
    `sample_axis` with an all-reduce over that dimension's group."""
    nt = mesh.size(mesh.mesh_dim_names.index(tile_axis))
    ns = mesh.size(mesh.mesh_dim_names.index(sample_axis))
    assert height % nt == 0, f"height {height} must divide over {nt} tiles"
    assert spp_total % ns == 0, f"spp {spp_total} must divide over {ns}"
    rows_per = height // nt
    spp_per = spp_total // ns
    tracer = get_tracer(backend)
    ti = mesh.get_local_rank(tile_axis)
    si = mesh.get_local_rank(sample_axis)

    def step(scene, camera, frame_count, jitter, accum):
        col = tracer(scene, camera, frame_count, jitter, width, rows_per,
                     spp_per, max_depth, row0=ti * rows_per,
                     full_height=height, total_spp=spp_total,
                     sample0=si * spp_per)
        col = _all_reduce_sum(col * (spp_per / spp_total), mesh,
                              sample_axis)
        return accumulate(accum, col, frame_count)

    return step


def sample_sharded_step(mesh: DeviceMesh, width: int, height: int,
                        spp_total: int, max_depth: int,
                        backend: str = "bvh"):
    """Sample streams split over the mesh: every rank renders the whole
    frame with its slice of the sample indices; col is the mean over the
    rank's spp_per samples, so the sum of col * spp_per / spp_total over
    ranks is the frame's mean, on every rank."""
    n = mesh.size()
    assert spp_total % n == 0, f"spp {spp_total} must divide over {n} devices"
    spp_per = spp_total // n
    tracer = get_tracer(backend)
    dev = mesh.get_local_rank(AXIS)

    def step(scene, camera, frame_count, jitter, accum):
        col = tracer(scene, camera, frame_count, jitter, width, height,
                     spp_per, max_depth, total_spp=spp_total,
                     sample0=dev * spp_per)
        col = _all_reduce_sum(col * (spp_per / spp_total), mesh, AXIS)
        return accumulate(accum, col, frame_count)

    return step
