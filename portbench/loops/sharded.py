"""A progressive render split by samples over the cell's cards: every rank
runs `parallel/sharding.py::sample_sharded_step` on its own card, on its
own copy of the scene, and the step's all-reduce leaves the frame's mean on
every card. Steps run back to back; rank 0 waits for each (a progressive
viewer waits for the step it shows), and a step ends there.

Configuration keys: `scene` (and `model`, `drivers.scene_source`),
`width`, `height`, `max_depth`, `ranks` (one a card), `spp_per_step` (the frame's samples a step, split over the
ranks), `backend` ("bvh": the scene is a DeviceScene), `check_pixels`.

Traffic keys:

- `frames_before_window`: steps in set-up (the first opens the NCCL
  communicators and captures the step's graph on every rank);
- `first_frame`, `frame_span`: the window starts at the progressive frame
  count `first_frame` + (a number below `frame_span` drawn from the seed),
  as a resumed render's count does; a step's work is the same at any count;
- `block`: steps between two words from rank 0, over a gloo group on the
  host, whether the window goes on: the only collective of the harness
  inside the window, so no rank is stopped mid-image and no NCCL kernel but
  the program's runs on a card;
- `check_frames`, `check_within`: the steps the output check traces again,
  drawn from the window's first `check_within`; each snapshot carries the
  PCG `streams` of its frame, the `jitter` the step was given (from the
  reference's `frame_jitter`, never the program's), every rank's
  accumulator as `rank_sums` and the ranks' `last_rays` summed;
- `trace_after`, `trace_seconds`: the profiled stretch of a traced run, on
  rank 0 only; its frames are steps, its rays rank 0's.

`Window.rays` is every rank's rays in the window, summed over the ranks
after it (host collective); the memory peak is the fullest card's. A
version of the program whose `ShardedStep` counts no rays (no
`last_rays`) makes the loop raise before any other rank is started. A rank
that fails, hangs or loads a forbidden module fails the run
(`lib/ranks.py`).
"""

from __future__ import annotations

import datetime
import random
import time

import numpy as np
import torch

from portbench.lib import drivers, ranks
from portbench.lib.profile import Spans
from portbench.lib.window import Window
from portbench.reference import pathtrace as pt

JOIN_S = 120.0  # how long the ranks have to end after the window


def run(cfg, traffic, seed, seconds, trace, device, phases,
        patterns) -> Window:
    import torch.distributed as dist

    from webgpu_raytracer_tpu_torch.parallel import sharding
    if not hasattr(sharding.ShardedStep, "last_rays"):
        raise RuntimeError("this version's ShardedStep counts no rays "
                           "(no last_rays): the cell has no rate to report")
    # `ranks.start` finds its target again by the module's name: this
    # file imported as a module of the package, not loaded by path.
    from portbench.loops.sharded import rank_loop as target
    phases.mark("program import")
    n = cfg["ranks"]
    group = ranks.start(n, target, (cfg, traffic, seed, seconds, device),
                        JOIN_S, device=device)
    with group:
        group.init()
        phases.mark("ranks started, rank 0 in the group")
        out = target(0, n, cfg, traffic, seed, seconds, device, trace,
                     phases, patterns)
        # Rank 0 leaves the group while the other ranks leave it (each as
        # its target returns), not after they have ended: NCCL's teardown
        # waits for every rank.
        dist.destroy_process_group()
        group.inited = False
        group.join()
    return Window(setup_s=out["t_open"] - phases.t_start,
                  t_open=out["t_open"], ends=out["ends"], rays=out["rays"],
                  pixels=cfg["width"] * cfg["height"], tris=0, light_rows=0,
                  snapshots=out["snaps"], trace=out["trace"],
                  memory_peak_bytes=max(out["peak"],
                                        group.memory_peak_bytes),
                  phases=phases.report())


def _scene(cfg, dev):
    """(DeviceScene, camera) of the configuration's scene on `dev`."""
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    world = NativeWorld(cfg["scene"], **drivers.scene_source(cfg))
    world.update_camera(cfg["width"], cfg["height"])
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    return build_device_scene(world, device=dev), cam


def rank_loop(rank, n, cfg, traffic, seed, seconds, device, trace=False,
              phases=None, patterns=None):
    """One rank, from its scene to the window's end; on rank 0 what the
    window gave (ends, rays of every rank, snapshots, trace, memory
    peak)."""
    import torch.distributed as dist

    from webgpu_raytracer_tpu_torch.parallel import sharding

    host = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=ranks.GROUP_S))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    W, H, spp = cfg["width"], cfg["height"], cfg["spp_per_step"]
    rnd = random.Random(seed)
    first = traffic["first_frame"] + rnd.randrange(traffic["frame_span"])
    checks = set(rnd.sample(range(traffic["check_within"]),
                            traffic["check_frames"]))
    px = drivers.pixels(rnd, cfg, dev)
    scene, cam = _scene(cfg, dev)
    step = sharding.sample_sharded_step(
        sharding.make_mesh(dev.type), W, H, spp, cfg["max_depth"],
        backend=cfg["backend"])
    acc = torch.zeros((W * H, 4), dtype=torch.float32, device=dev)
    jit = torch.zeros(2, dtype=torch.float32, device=dev)

    def jitter(f: int) -> np.ndarray:
        j = pt.frame_jitter(f, W, H)
        jit[0].fill_(float(j[0]))
        jit[1].fill_(float(j[1]))
        return j

    for f in range(1, traffic["frames_before_window"] + 1):
        jitter(f)
        step(scene, cam, f, jit, acc)
    drivers.sync(dev)
    if phases is not None:
        phases.mark("scene, step and warm-up (communicators, capture)")

    def snapshot(f, j, before) -> dict | None:
        mine = torch.tensor([float(acc.double().sum()), acc.numel(),
                             float(step.last_rays)], dtype=torch.float64)
        every = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(every, mine, group=host)
        if rank:
            return None
        return dict(frame=f, pixels=px, before=before, after=acc.clone(),
                    rays=float(sum(e[2] for e in every)), time=0.0,
                    streams=[f * spp + i for i in range(spp)],
                    jitter=j, rank_sums=[e[:2].tolist() for e in every])

    spans = Spans()
    stretch = (drivers.stretcher(trace, spans, traffic, seconds, patterns,
                                 "the harness's loop") if rank == 0 else None)
    rays, ends, snaps = [], [], []
    go = torch.ones(1, dtype=torch.int64)
    drivers.sync(dev)

    t_open = time.perf_counter()
    while go.item():
        for _ in range(traffic["block"]):
            k = len(rays)
            before = acc.clone() if k in checks and rank == 0 else None
            j = jitter(first + k)
            with spans("sharded.step"):
                step(scene, cam, first + k, jit, acc)
            if rank == 0:
                drivers.sync(dev)
                ends.append(time.perf_counter())
            rays.append(step.last_rays)
            if k in checks:
                snaps.append(snapshot(first + k, j, before))
            if stretch:
                stretch.boundary(ends[-1], t_open, rays, 0)
        go[0] = int(rank == 0 and drivers.more(t_open, seconds, stretch))
        dist.broadcast(go, 0, group=host)
    if stretch:
        stretch.close()
    drivers.sync(dev)
    total = torch.stack(rays).sum().double().cpu().reshape(1)
    dist.all_reduce(total, group=host)
    peak = drivers.memory_peak(dev)
    del step, scene, acc
    drivers.free()
    if rank:
        return None
    return dict(t_open=t_open, ends=ends, rays=float(total), snaps=snaps,
                trace=stretch.trace if stretch else None, peak=peak)
