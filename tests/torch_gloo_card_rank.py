"""One gloo rank of the sharded steps on the card (tests/test_torch_cuda.py).

    python tests/torch_gloo_card_rank.py RANK WORLD PORT OUT_DIR

NCCL refuses two ranks on one card; gloo lets them share it, and over gloo
a step that reduces is captured as two CUDA graphs with gloo's all-reduce
between them (`ShardedStep.split`). Starts a gloo process group at
tcp://127.0.0.1:PORT and renders cornell at RES x RES, depth DEPTH, on the
BVH path through the tile step (spp 1, this rank's band of rows) and the
sample step (spp SPP, the whole frame), each over frames 1..FRAMES at
jitter 0, first eager and then captured. Every captured frame must equal
the eager one bit for bit. Writes the captured accumulators, whether each
step is split and its capture count to OUT_DIR/rank<RANK>.npz. Imports no
JAX.
"""

import datetime
import os
import sys

import numpy as np
import torch

RES, DEPTH, SPP, FRAMES = 64, 3, 2, 3


def _frames(step, steps, scene, cam, rows: int) -> list:
    """FRAMES frames of `step` with `steps`, into a fresh accumulator: the
    accumulator after each."""
    step.steps = steps
    acc = torch.zeros((RES * rows, 4), device="cuda")
    jitter = torch.zeros(2, device="cuda")
    out = []
    for f in range(1, FRAMES + 1):
        assert step(scene, cam, f, jitter, acc) is acc
        out.append(acc.clone())
    return out


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.parallel import sharding
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            EagerSteps)
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        w = NativeWorld("cornell")
        w.update_camera(RES, RES)
        cam = torch.from_numpy(np.asarray(w.camera(), np.float32)).to(dev)
        scene = build_device_scene(w, device=dev)
        mesh = sharding.make_mesh("cuda")
        out = {}
        for kind, make, spp, rows in (
                ("band", sharding.tile_sharded_step, 1, RES // world),
                ("full", sharding.sample_sharded_step, SPP, RES)):
            step = make(mesh, RES, RES, spp, DEPTH)
            eager = _frames(step, EagerSteps(), scene, cam, rows)
            captured = CapturedSteps(dev)
            graph = _frames(step, captured, scene, cam, rows)
            for f, (a, b) in enumerate(zip(eager, graph)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                    f"rank {rank} {kind}: captured frame {f + 1} != eager"
            out[kind] = torch.stack(graph).cpu().numpy()
            out[f"{kind}_split"] = np.array(step.split)
            out[f"{kind}_captures"] = np.array(len(captured.captures))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
