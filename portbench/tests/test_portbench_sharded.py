"""The output check on a sample-sharded step's frames, on the CPU and on
the card.

A sharded step's sample is the mean of several PCG streams under the one
jitter its caller passes (`parallel/sharding.py::sample_sharded_step`), and
the all-reduce leaves the whole frame on every rank. A snapshot says so
with `streams`, `jitter` and `rank_sums` (`lib/check.py`). Here the
reference's streams are held to the program's plain tracer bit for bit,
and a 4-rank gloo world started by `lib/ranks.py` renders cornell at
16 x 16, depth 3, 4 samples a frame, one a rank: its snapshots come out
correct under `limits/cornell-interactive.json` (with `ranks_off_pct` held
at 0), and the bfloat16 control and each fault a sharded step can have
come out not correct. The rays are counted by the program's tracer
(`with_stats`) inside the step and summed over the ranks.

On the card (`cuda`), a NCCL world of one rank renders cornell at
1920 x 1080, depth 8, 4 samples a frame on the BVH path, through the
captured step; 3 of its first 40 steps are checked at every pixel.
"""

from __future__ import annotations

import contextlib
import json
import random
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from portbench.lib import check, ranks, spec
from portbench.reference import pathtrace as pt

BENCH = spec.Spec()
W = H = 16
DEPTH = 3
SPP = 4
FRAMES = (1, 2, 3)
LIMITS = dict(BENCH.limits("cornell-interactive"), ranks_off_pct=0.0)
FAULTS = ("one_stream_left_out", "streams_shifted_by_one",
          "share_scaled_by_one_over_spp_per", "one_rank_accumulator_altered",
          "ray_count_altered")
CASES = (("dense", None), ("bvh", None)) + tuple(
    ("dense", f) for f in FAULTS)


def _cfg(width, height, depth) -> dict:
    cell = BENCH.workload("cornell-interactive")
    return dict(BENCH.config(cell["config"]), width=width, height=height,
                max_depth=depth)


def _scene(backend: str, width: int, height: int, device):
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene
    from webgpu_raytracer_tpu_torch.render.worldtris import \
        build_world_tables

    world = NativeWorld("cornell")
    world.update_camera(width, height)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(device)
    if backend == "bvh":
        return build_device_scene(world, device=device), cam
    return (build_world_tables(world, device), None), cam


@contextlib.contextmanager
def _planted(rank: int, n: int, fault, rays):
    """The step's tracer (`ShardedStep._share` takes its radiance and
    exact ray count) also copies its rays into `rays`; `fault` breaks the
    step underneath, on this rank."""
    from webgpu_raytracer_tpu_torch.parallel import sharding
    get_tracer, share = sharding.get_tracer, sharding.ShardedStep._share
    accumulate = sharding.accumulate

    def counted(backend):
        tracer = get_tracer(backend)

        def trace(*a, **kw):
            if fault == "streams_shifted_by_one":
                kw["sample0"] += 1
            col, r = tracer(*a, **kw)
            if fault == "one_stream_left_out" and rank == n - 1:
                col, r = col * 0.0, r * 0
            if fault == "ray_count_altered":
                r = r * 1.25
            rays.copy_(r)
            return col, r
        return trace

    def wrong_share(self, *a, spp_per, total_spp, **kw):
        col, r = share(self, *a, spp_per=spp_per, total_spp=total_spp, **kw)
        return col * (total_spp / spp_per) / spp_per, r

    def altered(prev, col, frame_count):
        out = accumulate(prev, col, frame_count)
        out[7, 1] += 0.25
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(sharding, "get_tracer",
                                              counted))
        if fault == "share_scaled_by_one_over_spp_per":
            stack.enter_context(mock.patch.object(
                sharding.ShardedStep, "_share", wrong_share))
        if fault == "one_rank_accumulator_altered" and rank == 1:
            stack.enter_context(mock.patch.object(sharding, "accumulate",
                                                  altered))
        yield


def sharded_steps(rank: int, n: int, backend: str, fault, frames, snap,
                  size=(W, H, DEPTH, SPP), device="cpu") -> list:
    """Progressive frames `frames` (the frame count each step is given,
    under that frame's jitter from the reference's `frame_jitter`, so that
    the check takes no schedule the program made) of a `sample_sharded_step` of `size` =
    (width, height, depth, samples a frame) over the started process
    group; rank 0's snapshots of the steps whose frame is in `snap`."""
    import torch.distributed as dist

    from webgpu_raytracer_tpu_torch.parallel import sharding

    width, height, depth, spp = size
    scene, cam = _scene(backend, width, height, device)
    rays = torch.zeros((), dtype=torch.float64, device=device)
    snaps = []
    with _planted(rank, n, fault, rays):
        mesh = sharding.make_mesh(torch.device(device).type)
        step = sharding.sample_sharded_step(mesh, width, height, spp, depth,
                                            backend=backend)
        acc = torch.zeros((width * height, 4), device=device)
        for f in frames:
            jitter = torch.from_numpy(pt.frame_jitter(f, width, height)) \
                .to(device)
            before = acc.clone() if f in snap else None
            step(scene, cam, f, jitter, acc)
            if f not in snap:
                continue
            total = rays.clone()
            dist.all_reduce(total)
            mine = torch.tensor([float(acc.double().sum()), acc.numel()],
                                dtype=torch.float64, device=device)
            sums = [torch.empty_like(mine) for _ in range(n)]
            dist.all_gather(sums, mine)
            snaps.append(dict(
                frame=f, pixels=torch.arange(width * height, device=device),
                before=before, after=acc.clone(), rays=float(total),
                time=0.0, streams=[f * spp + i for i in range(spp)],
                jitter=jitter.cpu(), rank_sums=[s.tolist() for s in sums]))
    return snaps


def sharded_cases(rank: int, n: int, cases) -> dict:
    """Every case's snapshots, one case after the other, on every rank."""
    return {case: sharded_steps(rank, n, *case, FRAMES, FRAMES)
            for case in cases}


def _correct(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())


def _check(snaps, control=False, size=(W, H, DEPTH), device="cpu"):
    numbers, _ = check.check(SimpleNamespace(snapshots=snaps), _cfg(*size),
                             device, control=control)
    return numbers


@pytest.fixture(scope="module")
def sharded():
    """{(backend, fault): rank 0's snapshots} of a 4-rank gloo world."""
    group = ranks.start(4, sharded_cases, (CASES,), timeout_s=240,
                        device="cpu")
    with group:
        group.init()
        out = sharded_cases(0, 4, CASES)
        group.join()
    return out


# -- the reference's streams --------------------------------------------------

@pytest.mark.parametrize("frame", [1, 17, 987654])
def test_stream_and_jitter_default_to_the_frames(frame):
    """`radiance` with its keywords at their defaults gives the bits it
    gives with the frame's own stream and jitter spelled out."""
    w, h, d = 24, 16, 4
    arr = check.scene_arrays("cornell", w, h, 0.0)
    scene = pt.Scene(pt.world_tables(arr), "cpu")
    px = torch.arange(w * h)
    col, rays = pt.radiance(scene, arr["camera"], px, frame, w, h, d)
    col2, rays2 = pt.radiance(scene, arr["camera"], px, frame, w, h, d,
                              stream=frame,
                              jitter=pt.frame_jitter(frame, w, h))
    assert torch.equal(col.view(torch.int32), col2.view(torch.int32))
    assert torch.equal(rays, rays2)


@pytest.mark.parametrize("frame", [1, 987654, 2 ** 30 + 3])
def test_mean_of_streams_equals_the_programs_sample_step(frame):
    """The check's sample over streams 4f .. 4f+3 under one jitter against
    the program's plain dense tracer at spp 4, total_spp 4: every pixel
    bit for bit, and the ray count (the streams wrap past 2**32 at the
    last frame)."""
    from webgpu_raytracer_tpu_torch.ops.api import get_tracer

    scene, cam = _scene("dense", W, H, "cpu")
    jitter = torch.from_numpy(pt.frame_jitter(frame, W, H))
    col, rays = get_tracer("dense")(scene, cam, frame, jitter, W, H, SPP,
                                    DEPTH, total_spp=SPP, sample0=0,
                                    with_stats=True)
    arr = check.scene_arrays("cornell", W, H, 0.0)
    snap = dict(pixels=torch.arange(W * H), frame=frame, jitter=jitter,
                streams=[frame * SPP + i for i in range(SPP)])
    ref, ref_rays = check.sample(pt.Scene(pt.world_tables(arr), "cpu"),
                                 arr["camera"], snap, W, H, DEPTH)
    assert torch.equal(ref, col)
    assert int(ref_rays.sum()) == int(rays)


# -- a 4-rank gloo world ------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "bvh"])
def test_sharded_step_is_correct(sharded, backend):
    numbers = _check(sharded[(backend, None)])
    print(f"sharded {backend} readings: {json.dumps(numbers)}")
    assert _correct(numbers), numbers
    assert numbers["ranks_off_pct"] == 0.0


@pytest.mark.parametrize("fault", FAULTS)
def test_sharded_fault_is_not_correct(sharded, fault):
    numbers = _check(sharded[("dense", fault)])
    print(f"sharded {fault} readings: {json.dumps(numbers)}")
    assert not _correct(numbers), numbers


def test_sharded_control_is_not_correct(sharded):
    """The reference in bfloat16, in the program's place."""
    numbers = _check(sharded[("dense", None)], control=True)
    print(f"sharded control readings: {json.dumps(numbers)}")
    assert not _correct(numbers), numbers


def test_ranks_off_only_with_rank_sums(sharded):
    snaps = [{k: v for k, v in s.items() if k != "rank_sums"}
             for s in sharded[("dense", None)]]
    numbers = _check(snaps)
    assert "ranks_off_pct" not in numbers
    assert set(numbers) == set(BENCH.limits("cornell-interactive"))


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_one_rank_nccl_sample_step_at_1080p_on_the_card():
    """A NCCL world of one rank: `sample_sharded_step(mesh, 1920, 1080, 4,
    8)` on cornell, BVH backend, captured; 3 steps drawn from the first 40
    checked at every pixel, held to cornell-interactive's limits or, where
    the BVH kernels round past them, below the bfloat16 control's
    readings. Prints both readings and the check's seconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    size = (1920, 1080, 8, 4)
    snap = set(random.Random(20261018).sample(range(1, 41), 3))
    group = ranks.start(1, sharded_steps, timeout_s=120)
    with group:
        group.init()
        t0 = time.perf_counter()
        snaps = sharded_steps(0, 1, "bvh", None, range(1, 41), snap, size,
                              "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        numbers = _check(snaps, size=size[:3], device="cuda")
        t2 = time.perf_counter()
        control = _check(snaps, control=True, size=size[:3], device="cuda")
        group.join()
    print("sample_sharded_step 1080p: " + json.dumps(dict(
        frames=sorted(snap), program=numbers, control=control,
        run_s=t1 - t0, check_s=t2 - t1,
        card=torch.cuda.get_device_name(0))))
    assert numbers["ranks_off_pct"] == 0.0
    if not _correct(numbers):
        assert all(numbers[k] < control[k] for k in numbers
                   if k not in ("ranks_off_pct", "ldr_off_pct",
                                "history_off_pct")), (numbers, control)
