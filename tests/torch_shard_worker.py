"""One rank of the port's sharding tests (tests/test_torch_sharding.py).

    python tests/torch_shard_worker.py RANK WORLD PORT OUT_DIR

Starts a gloo process group at tcp://127.0.0.1:PORT, renders cornell at
W x H = 16 x 16, depth 3, through the port's sharded steps on the CPU for
both backends, and writes what this rank holds to OUT_DIR/rank<RANK>.npz:
the tile step's row band (spp 2) and the sample step's whole accumulator
(spp 8) on a 1-D mesh; with 4 ranks also the 2-D ("tile", "sample") step's
band (2 x 2 mesh, spp 4); and whether the steps refuse a height or an spp
that does not divide. With 2 ranks also FRAMES progressive frames of the
tile and sample steps into one accumulator (frame f's jitter
`frame_jitter(f, W, H)`), the frame count given as an int and, in a second
step, as a 0-d int64 tensor, and whether every call returned the
accumulator it was given. Every step's `last_rays` (the rank's own rays)
and the call's `kernels.launches["all_reduce"]` are written beside its
accumulator, and so is the step restated by hand (`by_hand`: the tracer,
the share's scale, the all-reduce, `accumulate`), which the step's
accumulator must equal bit for bit. With 4 ranks also two frames (1 and
CHECK_FRAMES[1]) of the sample step on cornell at CHECK_W x CHECK_H, depth
CHECK_DEPTH, CHECK_SPP samples a frame, BVH, under the reference's
`frame_jitter`: the accumulator before and after each, its float64 sum and
the rank's rays, for the benchmark's output check; once as the program
runs it and once under each of FAULTS, planted in the step (`planted`).
Imports no JAX.
"""

import contextlib
import datetime
import os
import sys
from unittest import mock

import numpy as np
import torch

W, H, DEPTH = 16, 16, 3
SPP_TILE, SPP_SAMPLE, SPP_2D = 2, 8, 4
BACKENDS = ("bvh", "dense")
FRAMES = 2
CHECK_W, CHECK_H, CHECK_DEPTH, CHECK_SPP = 32, 18, 8, 4
CHECK_FRAMES = (1, 77)
FAULTS = ("one_stream_left_out", "streams_shifted_by_one",
          "share_scaled_by_one_over_spp_per", "one_rank_accumulator_altered",
          "ray_count_altered")


def shard_scenes():
    """(camera, {backend: scene}) of cornell at W x H on the CPU; the BVH
    scene with tests/test_sharding.py's padding."""
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene
    from webgpu_raytracer_tpu_torch.render.worldtris import \
        build_world_tables

    world = NativeWorld("cornell")
    world.update_camera(W, H)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    return cam, {
        "bvh": build_device_scene(world, pad_nodes_to=32, pad_tris_to=64,
                                  pad_verts_to=64, device="cpu"),
        "dense": (build_world_tables(world, "cpu"), None)}


def progressive(step, scene, cam, rows: int, tensor_frames: bool):
    """FRAMES frames of `step` into one (W * rows, 4) accumulator: (the
    accumulator after each frame, stacked; whether every call returned the
    accumulator it was given)."""
    from webgpu_raytracer_tpu_torch.utils.halton import frame_jitter

    acc = torch.zeros((W * rows, 4))
    out, given = [], True
    for f in range(1, FRAMES + 1):
        jitter = torch.from_numpy(frame_jitter(f, W, H))
        frame = torch.tensor(f) if tensor_frames else f
        res = step(scene, cam, frame, jitter, acc)
        given &= res is acc
        out.append(res.clone())
    return np.stack(out), given


def by_hand(scene, cam, jitter, b, rows, spp, total_spp, row0=0, sample0=0,
            group=None):
    """The sharded step of frame 1 restated: this rank's radiance, scaled
    by its share and summed over `group` where there is one, accumulated
    into a fresh accumulator."""
    import torch.distributed as dist

    from webgpu_raytracer_tpu_torch.ops.api import get_tracer
    from webgpu_raytracer_tpu_torch.ops.trace import accumulate

    col = get_tracer(b)(scene, cam, 1, jitter, W, rows, spp, DEPTH,
                        row0=row0, full_height=H, total_spp=total_spp,
                        sample0=sample0)
    if group is not None:
        col = col * (spp / total_spp)
        dist.all_reduce(col, group=group)
    return accumulate(torch.zeros((W * rows, 4)), col, 1).numpy()


def _kept(out, name, step, *args) -> None:
    """A call of `step` on `args`: its accumulator, rays and all-reduces,
    under `name`."""
    from webgpu_raytracer_tpu_torch import kernels

    before = kernels.launches["all_reduce"]
    out[name] = step(*args).numpy()
    out[f"rays_{name}"] = np.array(float(step.last_rays))
    out[f"all_reduce_{name}"] = np.array(kernels.launches["all_reduce"]
                                         - before)


@contextlib.contextmanager
def planted(fault, rank: int, world: int):
    """`fault` (one of FAULTS, or None for none) planted in the sharded
    step on this rank, at the step's own seams: its tracer's (radiance,
    rays), `ShardedStep._share`'s (scaled share, rays) and `accumulate`."""
    from webgpu_raytracer_tpu_torch.parallel import sharding

    get_tracer, share = sharding.get_tracer, sharding.ShardedStep._share
    accumulate = sharding.accumulate

    def faulty_tracer(backend):
        trace = get_tracer(backend)

        def faulty(*a, **kw):
            if fault == "streams_shifted_by_one":
                kw["sample0"] += 1
            col, rays = trace(*a, **kw)
            if fault == "one_stream_left_out" and rank == world - 1:
                col, rays = col * 0.0, rays * 0
            if fault == "ray_count_altered":
                rays = rays * 1.25
            return col, rays
        return faulty

    def wrong_share(self, *a, spp_per, total_spp, **kw):
        col, rays = share(self, *a, spp_per=spp_per, total_spp=total_spp,
                          **kw)
        return col * (total_spp / spp_per) / spp_per, rays

    def altered(prev, col, frame_count):
        out = accumulate(prev, col, frame_count)
        out[7, 1] += 0.25
        return out

    with contextlib.ExitStack() as stack:
        if fault in ("streams_shifted_by_one", "one_stream_left_out",
                     "ray_count_altered"):
            stack.enter_context(mock.patch.object(sharding, "get_tracer",
                                                  faulty_tracer))
        if fault == "share_scaled_by_one_over_spp_per":
            stack.enter_context(mock.patch.object(
                sharding.ShardedStep, "_share", wrong_share))
        if fault == "one_rank_accumulator_altered" and rank == 1:
            stack.enter_context(mock.patch.object(sharding, "accumulate",
                                                  altered))
        yield


def checked_frames(mesh, rank: int, world: int) -> dict:
    """CHECK_FRAMES of the sample step at the check's size, BVH, as the
    program runs it ("ok") and under each of FAULTS, into a fresh
    accumulator each."""
    from portbench.reference import pathtrace as pt
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.parallel import sharding
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    native = NativeWorld("cornell")
    native.update_camera(CHECK_W, CHECK_H)
    cam = torch.from_numpy(np.asarray(native.camera(), np.float32))
    scene = build_device_scene(native, device="cpu")
    out = {}
    for case in (None,) + FAULTS:
        tag = case or "ok"
        acc = torch.zeros((CHECK_W * CHECK_H, 4))
        with planted(case, rank, world):
            step = sharding.sample_sharded_step(mesh, CHECK_W, CHECK_H,
                                                CHECK_SPP, CHECK_DEPTH)
            for f in CHECK_FRAMES:
                jitter = torch.from_numpy(pt.frame_jitter(f, CHECK_W,
                                                          CHECK_H))
                out[f"check_{tag}_before_{f}"] = acc.numpy().copy()
                step(scene, cam, f, jitter, acc)
                out[f"check_{tag}_after_{f}"] = acc.numpy().copy()
                out[f"check_{tag}_rays_{f}"] = np.array(
                    float(step.last_rays))
                out[f"check_{tag}_sum_{f}"] = np.array(
                    [float(acc.double().sum()), acc.numel()])
    return out


def _refuses(build) -> bool:
    try:
        build()
    except AssertionError:
        return True
    return False


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from webgpu_raytracer_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    cam, scenes = shard_scenes()
    jitter = torch.zeros(2)
    out = {}
    mesh = sharding.make_mesh("cpu")
    coord = mesh.get_local_rank(sharding.AXIS)
    for b in BACKENDS:
        rows = H // world
        step = sharding.tile_sharded_step(mesh, W, H, SPP_TILE, DEPTH,
                                          backend=b)
        _kept(out, f"tile_{b}", step, scenes[b], cam, 1, jitter,
              torch.zeros((W * rows, 4)))
        out[f"hand_tile_{b}"] = by_hand(scenes[b], cam, jitter, b, rows,
                                        SPP_TILE, SPP_TILE, coord * rows)
        step = sharding.sample_sharded_step(mesh, W, H, SPP_SAMPLE, DEPTH,
                                            backend=b)
        _kept(out, f"sample_{b}", step, scenes[b], cam, 1, jitter,
              torch.zeros((W * H, 4)))
        spp = SPP_SAMPLE // world
        out[f"hand_sample_{b}"] = by_hand(
            scenes[b], cam, jitter, b, H, spp, SPP_SAMPLE, 0, coord * spp,
            mesh.get_group(sharding.AXIS))
    if world == 2:
        given = []
        for b in BACKENDS:
            for kind, make, spp, rows in (
                    ("tile", sharding.tile_sharded_step, SPP_TILE, H // 2),
                    ("sample", sharding.sample_sharded_step, SPP_SAMPLE, H)):
                for tensor_frames, tag in ((False, ""), (True, "_tensor")):
                    step = make(mesh, W, H, spp, DEPTH, backend=b)
                    out[f"prog_{kind}_{b}{tag}"], ok = progressive(
                        step, scenes[b], cam, rows, tensor_frames)
                    given.append(ok)
        out["prog_given"] = np.array(given)
    out["refuses"] = np.array([
        _refuses(lambda: sharding.tile_sharded_step(mesh, W, H + 1, 1, 1)),
        _refuses(lambda: sharding.sample_sharded_step(mesh, W, H,
                                                      world + 1, 1))])
    if world == 4:
        mesh2 = sharding.make_mesh("cpu", (2, 2), ("tile", "sample"))
        out["coord"] = np.array([mesh2.get_local_rank("tile"),
                                 mesh2.get_local_rank("sample")])
        ti, si = (int(c) for c in out["coord"])
        for b in BACKENDS:
            step = sharding.tile_sample_sharded_step(mesh2, W, H, SPP_2D,
                                                     DEPTH, backend=b)
            _kept(out, f"tile_sample_{b}", step, scenes[b], cam, 1, jitter,
                  torch.zeros((W * H // 2, 4)))
            out[f"hand_tile_sample_{b}"] = by_hand(
                scenes[b], cam, jitter, b, H // 2, SPP_2D // 2, SPP_2D,
                ti * (H // 2), si * (SPP_2D // 2), mesh2.get_group("sample"))
        out.update(checked_frames(mesh, rank, world))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
