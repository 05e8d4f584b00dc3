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
accumulator it was given. Imports no JAX.
"""

import datetime
import os
import sys

import numpy as np
import torch

W, H, DEPTH = 16, 16, 3
SPP_TILE, SPP_SAMPLE, SPP_2D = 2, 8, 4
BACKENDS = ("bvh", "dense")
FRAMES = 2


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
    for b in BACKENDS:
        rows = H // world
        step = sharding.tile_sharded_step(mesh, W, H, SPP_TILE, DEPTH,
                                          backend=b)
        out[f"tile_{b}"] = step(scenes[b], cam, 1, jitter,
                                torch.zeros((W * rows, 4))).numpy()
        step = sharding.sample_sharded_step(mesh, W, H, SPP_SAMPLE, DEPTH,
                                            backend=b)
        out[f"sample_{b}"] = step(scenes[b], cam, 1, jitter,
                                  torch.zeros((W * H, 4))).numpy()
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
        for b in BACKENDS:
            step = sharding.tile_sample_sharded_step(mesh2, W, H, SPP_2D,
                                                     DEPTH, backend=b)
            out[f"tile_sample_{b}"] = step(
                scenes[b], cam, 1, jitter, torch.zeros((W * H // 2, 4))) \
                .numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
