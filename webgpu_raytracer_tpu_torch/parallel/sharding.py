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

Each of the three step functions returns a `ShardedStep`, the counterpart
of the JAX package's `jax.jit(shard_map(...), donate_argnums=(4,))`: on a
CUDA mesh (`make_mesh("cuda")`) a call replays a CUDA graph of the step's
body (trace, the share's scale, the all-reduce, accumulate) with the
all-reduce recorded in it where the group's backend is NCCL; gloo reduces
CUDA tensors through the host, which no graph can hold, so there the body
is two graphs with the all-reduce between them. On a CPU mesh the body
runs eagerly (`EagerSteps`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import kernels
from ..ops.api import get_tracer
from ..ops.trace import accumulate
from ..render.renderer import CapturedSteps, EagerSteps
from ..utils.profiling import count, span

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


def reduces_in_graph(group) -> bool:
    """Whether an all-reduce of CUDA tensors over `group` can be recorded
    in a CUDA graph: NCCL's runs on the card and can; gloo's goes through
    the host and cannot. A group of several backends ("cpu:gloo,cuda:nccl")
    is read for its CUDA one."""
    backend = str(dist.get_backend(group))
    by_device = (dict(p.split(":") for p in backend.split(","))
                 if ":" in backend else {"cuda": backend})
    return by_device.get("cuda") == "nccl"


class ShardedStep:
    """One rank's sharded step: step(scene, camera, frame_count, jitter,
    accum) -> accum, the JAX package's jitted step with its signature.

    `static` holds the step's static arguments, fixed by the rank's mesh
    coordinate when the step is built: width, rows_per, spp_per, max_depth,
    backend, row0, sample0, full_height and total_spp. `group` is the
    all-reduce's process group (None: the tile step, no collective).

    `steps` runs the body: `CapturedSteps` on a CUDA mesh (one graph for
    each `step_key`; a capture that fails raises), `EagerSteps` on a CPU
    mesh; set `step.steps = EagerSteps()` on the card for the eager step.
    `split` is True where the group reduces through the host (gloo with
    CUDA tensors): the body before the all-reduce and the one after it are
    then two graphs, and the all-reduce runs between them. The step's
    static arguments name no height, so `CapturedSteps` never drops its
    entries by image size: they live as long as the step, one for each
    signature of the arguments (a scene of other shapes adds one).

    `frame_count` is an int or a 0-d int64 tensor on the mesh's device;
    an int is filled into the step's own tensor, so every frame replays
    the same graph. `accum` is written and returned: the JAX
    package's donated argument. On the card the first call's tensors are
    the graph's, and a later call copies in any tensor that is not one of
    them; an accumulator that is not the graph's is copied in, and the
    result back into it (the graph's accumulator then holds it too, as a
    donated buffer is not read again).

    After a call, `last_rays` is the exact float64 device count of the rays
    this rank traced (its own samples, not scaled by its share; None before
    the first call), unread until needed, as `Renderer.last_rays`; the
    ranks' counts summed are the frame's.

    Spans: `sharded.step` (its frame id the frame count given as an int),
    with `sharded.inputs` (the frame count's fill), the steps' own and, on
    the split path, `sharded.all_reduce` (the collective through the host).
    Counters: `sharded_steps`, one a call, and `all_reduce_bytes`, the
    bytes a call's all-reduce sums."""

    last_rays = None

    def __init__(self, mesh: DeviceMesh, static: dict, group=None):
        self.static = static
        self.group = group
        on_card = mesh.device_type == "cuda"
        device = torch.device("cuda", torch.cuda.current_device()) \
            if on_card else torch.device("cpu")
        self.steps = CapturedSteps(device) if on_card else EagerSteps()
        self.split = (on_card and group is not None
                      and not reduces_in_graph(group))
        self._frame = torch.zeros((), dtype=torch.int64, device=device)
        self._col = None  # the split step's shares, its first graph's output

    def __call__(self, scene, camera, frame_count, jitter, accum):
        frame = frame_count if isinstance(frame_count, int) else None
        with span("sharded.step", frame):
            with span("sharded.inputs"):
                if not isinstance(frame_count, torch.Tensor):
                    frame_count = self._frame.fill_(frame_count)
            if self.split:
                if self._col is None:
                    self._col = torch.empty((accum.shape[0], 3),
                                            device=accum.device)
                (col, rays), _ = self.steps.run(
                    self._before, (scene, camera, frame_count, jitter,
                                   self._col), self.static, donate=(4,))
                with span("sharded.all_reduce"):
                    self._all_reduce(col)
                (out,), _ = self.steps.run(
                    self._after, (col, frame_count, accum), self.static,
                    donate=(2,))
            else:
                (out, rays), _ = self.steps.run(
                    self._body, (scene, camera, frame_count, jitter, accum),
                    self.static, donate=(4,))
            self.last_rays = rays
            count("sharded_steps")
            if self.group is not None:
                count("all_reduce_bytes", 3 * 4 * accum.shape[0])
        return out if out is accum else accum.copy_(out)

    def _share(self, scene, camera, frame_count, jitter, *, width, rows_per,
               spp_per, max_depth, backend, row0, sample0, full_height,
               total_spp):
        """(this rank's radiance, scaled by its share of the frame's samples
        where an all-reduce sums the shares; the rank's exact ray count)."""
        col, rays = get_tracer(backend)(
            scene, camera, frame_count, jitter, width, rows_per, spp_per,
            max_depth, row0=row0, full_height=full_height,
            total_spp=total_spp, sample0=sample0, with_stats=True)
        return (col if self.group is None
                else col * (spp_per / total_spp)), rays

    def _all_reduce(self, col):
        dist.all_reduce(col, op=dist.ReduceOp.SUM, group=self.group)
        kernels.launches["all_reduce"] += 1

    def _body(self, scene, camera, frame_count, jitter, accum, **static):
        """The whole step: trace, scale, all-reduce, accumulate."""
        col, rays = self._share(scene, camera, frame_count, jitter, **static)
        if self.group is not None:
            self._all_reduce(col)
        return accumulate(accum, col, frame_count), rays

    def _before(self, scene, camera, frame_count, jitter, col, **static):
        """The split step's first graph: the scaled share, into `col`."""
        share, rays = self._share(scene, camera, frame_count, jitter,
                                  **static)
        return col.copy_(share), rays

    def _after(self, col, frame_count, accum, **static):
        """The split step's second graph: accumulate the summed shares."""
        return (accumulate(accum, col, frame_count),)


def tile_sharded_step(mesh: DeviceMesh, width: int, height: int, spp: int,
                      max_depth: int, backend: str = "bvh") -> ShardedStep:
    """Pixel rows split over the mesh; each rank traces its band with the
    frame's pixel indices, so the bands are the one-device frame."""
    n = mesh.size()
    assert height % n == 0, f"height {height} must divide over {n} devices"
    rows_per = height // n
    return ShardedStep(mesh, dict(
        width=width, rows_per=rows_per, spp_per=spp, max_depth=max_depth,
        backend=backend, row0=mesh.get_local_rank(AXIS) * rows_per,
        sample0=0, full_height=height, total_spp=spp))


def tile_sample_sharded_step(mesh: DeviceMesh, width: int, height: int,
                             spp_total: int, max_depth: int,
                             tile_axis: str = "tile",
                             sample_axis: str = "sample",
                             backend: str = "bvh") -> ShardedStep:
    """2-D mesh: rows split over `tile_axis`, sample streams over
    `sample_axis` with an all-reduce over that dimension's group."""
    nt = mesh.size(mesh.mesh_dim_names.index(tile_axis))
    ns = mesh.size(mesh.mesh_dim_names.index(sample_axis))
    assert height % nt == 0, f"height {height} must divide over {nt} tiles"
    assert spp_total % ns == 0, f"spp {spp_total} must divide over {ns}"
    rows_per = height // nt
    spp_per = spp_total // ns
    return ShardedStep(mesh, dict(
        width=width, rows_per=rows_per, spp_per=spp_per, max_depth=max_depth,
        backend=backend, row0=mesh.get_local_rank(tile_axis) * rows_per,
        sample0=mesh.get_local_rank(sample_axis) * spp_per,
        full_height=height, total_spp=spp_total),
        mesh.get_group(sample_axis))


def sample_sharded_step(mesh: DeviceMesh, width: int, height: int,
                        spp_total: int, max_depth: int,
                        backend: str = "bvh") -> ShardedStep:
    """Sample streams split over the mesh: every rank renders the whole
    frame with its slice of the sample indices; col is the mean over the
    rank's spp_per samples, so the sum of col * spp_per / spp_total over
    ranks is the frame's mean, on every rank."""
    n = mesh.size()
    assert spp_total % n == 0, f"spp {spp_total} must divide over {n} devices"
    spp_per = spp_total // n
    return ShardedStep(mesh, dict(
        width=width, rows_per=height, spp_per=spp_per, max_depth=max_depth,
        backend=backend, row0=0,
        sample0=mesh.get_local_rank(AXIS) * spp_per, full_height=height,
        total_spp=spp_total), mesh.get_group(AXIS))
