"""The port's sharded steps (parallel/sharding.py) over gloo, on the CPU.

2 and 4 spawned processes (tests/torch_shard_worker.py, one rank each)
render cornell at W x H = 16 x 16, depth 3 (tests/test_sharding.py's
frame) for both backends. As in the JAX package's tests: the tile step's
row bands put together equal one process's frame bit for bit (the
counter-based RNG depends only on the pixel and the sample); the sample
step and the 2 x 2 ("tile", "sample") mesh are held at rtol / atol 2e-5
(the all-reduce sums in its own order), and every rank holds the same
sample-step accumulator. The one-process frame is held to JAX
`trace_pixels` at tests/test_torch_slice.py's tolerance. Every rank's join
has a timeout, so a hung rank fails its test instead of stalling the run.

Two progressive frames of the tile and sample steps on 2 ranks, both
backends, are held to the JAX package's own `tile_sharded_step` /
`sample_sharded_step` on a 2-device virtual CPU mesh (tests/conftest.py
gives JAX 8), at tests/test_torch_slice.py's tolerance (>= 95% of pixels
at rel < 1e-3, the mean within 2%; the sample count exact); a frame count
given as a 0-d int64 tensor gives the int's bits, and every call returns
the accumulator it was given (JAX's donated argument).

In this process, a gloo world of one rank runs `ShardedStep` through
`CapturedSteps` with the CUDA graph's CPU stand-in
(`tests.torch_common.record_eagerly`): the whole body and the split one
(two graphs with the all-reduce between them, gloo's form on the card)
equal the eager step bit for bit over three frames, one capture per body
and none per frame.

The ray count and the restated step: in the 2- and 4-rank
worlds each rank's `last_rays` equals the one-process `with_stats` count
of its own rows or samples exactly, and the ranks' counts summed equal
the whole frame's; the tile, sample and 2-D accumulators equal the step
restated by hand (tracer, share, all-reduce, `accumulate`) bit for bit;
`launches["all_reduce"]` counts one a collective. The 4-rank BVH sample
step of cornell at 32 x 18, depth 8, 4 samples a frame passes the
benchmark's output check (`portbench/lib/check.py` against the plain
reference, `portbench/limits/cornell1080-sample4.json`) with every number
at 0; its bfloat16 control does not, nor does the step under each fault
a sharded step can have, planted at its seams (a stream left out, the
streams shifted by one, the share scaled by 1 / spp_per, one rank's
accumulator altered, the ray count altered). Under `tracing()` the world of
one records the spans `sharded.step` > `sharded.inputs` (and
`sharded.all_reduce` on the split path) and counts `sharded_steps` and
`all_reduce_bytes`; with tracing off it records no span.
"""

import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from webgpu_raytracer_tpu.models.native import NativeWorld as JaxWorld
from webgpu_raytracer_tpu.ops.trace import trace_pixels as jax_trace
from webgpu_raytracer_tpu.parallel import sharding as jax_sharding
from webgpu_raytracer_tpu.render.resources import \
    build_device_scene as jax_scene
from webgpu_raytracer_tpu.render.worldtris import build_world_tris
from portbench.lib import check
from portbench.reference import pathtrace as pt
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops.api import get_tracer
from webgpu_raytracer_tpu_torch.ops.trace import accumulate
from webgpu_raytracer_tpu_torch.parallel import sharding
from webgpu_raytracer_tpu_torch.render import renderer as prr
from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                        EagerSteps, step_key)
from webgpu_raytracer_tpu_torch.utils.halton import frame_jitter
from webgpu_raytracer_tpu_torch.utils.profiling import (counters, spans,
                                                        tracing)

from tests.torch_common import record_eagerly
from tests.torch_shard_worker import (BACKENDS, CHECK_DEPTH, CHECK_FRAMES,
                                      CHECK_H, CHECK_SPP, CHECK_W, DEPTH,
                                      FAULTS, FRAMES, H, SPP_2D, SPP_SAMPLE,
                                      SPP_TILE, W, progressive, shard_scenes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_shard_worker.py")
BENCH_CONFIG = os.path.join(REPO, "portbench", "configs",
                            "cornell_1920x1080_d8.json")
BENCH_LIMITS = os.path.join(REPO, "portbench", "limits",
                            "cornell1080-sample4.json")
JOIN_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, out_dir: str):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(port), out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs) -> list:
    """Wait for every rank; on a timeout kill them all and fail."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not finish within {JOIN_TIMEOUT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank 0's npz, rank 1's, ...]} for 2 and 4 ranks, run at
    the same time."""
    dirs = {n: str(tmp_path_factory.mktemp(f"world{n}")) for n in (2, 4)}
    procs = {n: _launch(n, d) for n, d in dirs.items()}
    for n in procs:
        _join(procs[n])
    return {n: [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                for r in range(n)] for n, d in dirs.items()}


@pytest.fixture(scope="module")
def reference():
    """{(backend, spp): one process's accumulator after frame 1}."""
    cam, scenes = shard_scenes()
    out = {}
    for b in BACKENDS:
        for spp in (SPP_TILE, SPP_SAMPLE, SPP_2D):
            col = get_tracer(b)(scenes[b], cam, 1, torch.zeros(2), W, H,
                                spp, DEPTH)
            out[b, spp] = accumulate(torch.zeros((W * H, 4)), col, 1).numpy()
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_sharding_bit_exact(ranks, reference, world, backend):
    bands = np.concatenate([r[f"tile_{backend}"] for r in ranks[world]])
    np.testing.assert_array_equal(bands.view(np.int32),
                                  reference[backend, SPP_TILE].view(np.int32))
    assert bands[:, :3].mean() > 0.05


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sample_sharding_matches(ranks, reference, world, backend):
    outs = [r[f"sample_{backend}"] for r in ranks[world]]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])  # replicated
    np.testing.assert_allclose(outs[0], reference[backend, SPP_SAMPLE],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_sample_2d_mesh(ranks, reference, backend):
    by_coord = {tuple(r["coord"]): r[f"tile_sample_{backend}"]
                for r in ranks[4]}
    assert sorted(by_coord) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for ti in (0, 1):
        np.testing.assert_array_equal(by_coord[ti, 0], by_coord[ti, 1])
    out = np.concatenate([by_coord[0, 0], by_coord[1, 0]])
    np.testing.assert_allclose(out, reference[backend, SPP_2D], rtol=2e-5,
                               atol=2e-5)


def test_steps_refuse_what_does_not_divide(ranks):
    for world in (2, 4):
        for r in ranks[world]:
            assert r["refuses"].all(), world


def test_one_process_frame_matches_jax(reference):
    """The BVH reference against JAX `trace_pixels` on the same scene."""
    world = JaxWorld("cornell")
    world.update_camera(W, H)
    scene = jax_scene(world, pad_nodes_to=32, pad_tris_to=64,
                      pad_verts_to=64)
    a = np.asarray(jax_trace(scene, jnp.asarray(world.camera()),
                             jnp.asarray(1, jnp.int32),
                             jnp.zeros(2, jnp.float32), W, H, SPP_TILE,
                             DEPTH))
    b = reference["bvh", SPP_TILE][:, :3]
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    assert (rel < 1e-3).mean() >= 0.95
    assert abs(a.mean() - b.mean()) < 0.02 * a.mean()


# -- two progressive frames against the JAX package's sharded steps ----------

def _near(a, b, what):
    """tests/test_torch_slice.py's tolerance on the radiance columns; the
    sample count column exact."""
    rel = np.abs(a[:, :3] - b[:, :3]).max(1) / np.maximum(
        np.abs(a[:, :3]).max(1), 1e-3)
    frac = (rel < 1e-3).mean()
    assert frac >= 0.95, f"{what}: {frac:.3%} pixels match"
    assert abs(a[:, :3].mean() - b[:, :3].mean()) \
        < 0.02 * max(a[:, :3].mean(), 1e-3), what
    np.testing.assert_array_equal(a[:, 3], b[:, 3])


@pytest.fixture(scope="module")
def jax_steps():
    """{(kind, backend): JAX's accumulator after each of FRAMES frames},
    the JAX package's sharded steps on a 2-device virtual CPU mesh."""
    world = JaxWorld("cornell")
    world.update_camera(W, H)
    bvh = jax_scene(world, pad_nodes_to=32, pad_tris_to=64, pad_verts_to=64)
    scenes = {"bvh": bvh, "dense": (build_world_tris(world), bvh.textures)}
    cam = jnp.asarray(world.camera())
    mesh = jax_sharding.make_mesh(jax.devices()[:2])
    out = {}
    for b in BACKENDS:
        for kind, make, spp in (
                ("tile", jax_sharding.tile_sharded_step, SPP_TILE),
                ("sample", jax_sharding.sample_sharded_step, SPP_SAMPLE)):
            step = make(mesh, W, H, spp, DEPTH, backend=b)
            acc, frames = jnp.zeros((W * H, 4)), []
            for f in range(1, FRAMES + 1):
                acc = step(scenes[b], cam, jnp.asarray(f, jnp.int32),
                           jnp.asarray(frame_jitter(f, W, H)), acc)
                frames.append(np.asarray(acc))
            out[kind, b] = np.stack(frames)
    return out


def _port_frames(ranks, kind, b, tag=""):
    """The port's accumulator after each frame on 2 ranks: the tile
    step's bands put together, or rank 0's sample-step accumulator (both
    ranks hold the same)."""
    two = ranks[2]
    if kind == "tile":
        return np.concatenate([r[f"prog_tile_{b}{tag}"] for r in two], 1)
    np.testing.assert_array_equal(two[0][f"prog_sample_{b}{tag}"],
                                  two[1][f"prog_sample_{b}{tag}"])
    return two[0][f"prog_sample_{b}{tag}"]


@pytest.mark.parametrize("kind", ["tile", "sample"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_progressive_frames_match_jax_sharded_steps(ranks, jax_steps, kind,
                                                    backend):
    port = _port_frames(ranks, kind, backend)
    want = jax_steps[kind, backend]
    assert port.shape == want.shape == (FRAMES, W * H, 4)
    for f in range(FRAMES):
        _near(want[f], port[f], f"{kind} {backend} frame {f + 1}")
    assert port[-1, :, 3].min() == FRAMES  # frame 2 added to frame 1


@pytest.mark.parametrize("kind", ["tile", "sample"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_frame_tensor_bit_equal_to_int(ranks, kind, backend):
    a = _port_frames(ranks, kind, backend)
    b = _port_frames(ranks, kind, backend, "_tensor")
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_steps_return_the_given_accumulator(ranks):
    """JAX donates `accum` (donate_argnums=(4,)); the port writes it."""
    given = ranks[2][0]["prog_given"]
    assert given.shape == (2 * len(BACKENDS) * 2,) and given.all()
    assert ranks[2][1]["prog_given"].all()


# -- the captured body, with a stand-in for the CUDA graph --------------------

@pytest.fixture(scope="module")
def world_of_one():
    """A gloo process group of one rank in this process: (1-D mesh, 1 x 1
    ("tile", "sample") mesh); destroyed after this module's tests."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    yield (sharding.make_mesh("cpu"),
           sharding.make_mesh("cpu", (1, 1), ("tile", "sample")))
    dist.destroy_process_group()


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(CapturedSteps, "_record", record_eagerly)
    monkeypatch.setattr(prr.kernels, "library", lambda: None)


def _make(kind, meshes, backend="bvh"):
    mesh, mesh2 = meshes
    if kind == "tile":
        return sharding.tile_sharded_step(mesh, W, H, SPP_TILE, DEPTH,
                                          backend=backend)
    if kind == "sample":
        return sharding.sample_sharded_step(mesh, W, H, 2, DEPTH,
                                            backend=backend)
    return sharding.tile_sample_sharded_step(mesh2, W, H, 2, DEPTH,
                                             backend=backend)


@pytest.mark.parametrize("kind,split", [("tile", False), ("sample", False),
                                        ("sample", True), ("2d", False),
                                        ("2d", True)])
def test_captured_sharded_step_equals_eager(world_of_one, captured, kind,
                                            split):
    """Three frames with int frame counts through the cache (the whole
    body, or the split: two graphs, the all-reduce between them) against
    the eager step: the same bits, the given accumulator returned, one
    capture per body over all frames, every graph replayed every frame."""
    cam, scenes = shard_scenes()
    eager, graph = _make(kind, world_of_one), _make(kind, world_of_one)
    assert isinstance(eager.steps, EagerSteps) and not eager.split
    graph.steps, graph.split = CapturedSteps("cpu"), split
    acc_e, acc_g = torch.zeros((W * H, 4)), torch.zeros((W * H, 4))
    for f in range(1, 4):
        jitter = torch.from_numpy(frame_jitter(f, W, H))
        assert eager(scenes["bvh"], cam, f, jitter, acc_e) is acc_e
        assert graph(scenes["bvh"], cam, f, jitter, acc_g) is acc_g
        assert torch.equal(acc_e.view(torch.int32), acc_g.view(torch.int32))
    entries = graph.steps.entries.values()
    assert len(graph.steps.captures) == (2 if split else 1)
    assert all(e.graph.replays == 3 for e in entries)


def test_sharded_steps_of_one_signature_keep_their_own_graphs(
        world_of_one, captured):
    """Two tile steps of one signature, on one cache: two keys, two
    graphs, each equal to its own eager frames; the 2-D step's body
    against the tile step's, and a Renderer's `render_step`, never share
    a key."""
    cam, scenes = shard_scenes()
    a, b = _make("tile", world_of_one), _make("tile", world_of_one)
    args = (scenes["bvh"], cam, torch.tensor(1), torch.zeros(2),
            torch.zeros((W * H, 4)))
    assert a._body.__name__ == b._body.__name__
    assert step_key(a._body, args, a.static) != step_key(b._body, args,
                                                         b.static)
    assert step_key(prr.render_step, args, a.static) \
        != step_key(a._body, args, a.static)
    b.steps = a.steps = CapturedSteps("cpu")
    want = progressive(_make("tile", world_of_one), scenes["bvh"], cam, H,
                       False)[0]
    for step in (a, b):
        got, given = progressive(step, scenes["bvh"], cam, H, False)
        assert given
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    assert len(a.steps.captures) == 2
    two_d = _make("2d", world_of_one)
    assert step_key(two_d._body, args, two_d.static) \
        != step_key(a._body, args, a.static)


# -- the ranks' ray counts, and the steps restated by hand --------------------

@pytest.fixture(scope="module")
def scenes():
    return shard_scenes()


def _slice_rays(scenes, backend, kind, world, coord) -> float:
    """One process's `with_stats` ray count of a rank's part of frame 1:
    its rows (tile), its samples (sample) or both (2-D, coord (tile,
    sample) on a 2 x 2 mesh)."""
    cam, by_backend = scenes
    if kind == "tile":
        rows, spp, total, row0, sample0 = (H // world, SPP_TILE, SPP_TILE,
                                           coord * (H // world), 0)
    elif kind == "sample":
        spp = SPP_SAMPLE // world
        rows, total, row0, sample0 = H, SPP_SAMPLE, 0, coord * spp
    else:
        rows, spp = H // 2, SPP_2D // 2
        total, row0, sample0 = SPP_2D, coord[0] * rows, coord[1] * spp
    _, rays = get_tracer(backend)(by_backend[backend], cam, 1, torch.zeros(2),
                                  W, rows, spp, DEPTH, row0=row0,
                                  full_height=H, total_spp=total,
                                  sample0=sample0, with_stats=True)
    return float(rays)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["tile", "sample"])
def test_each_ranks_last_rays_is_its_own_slice(ranks, scenes, world,
                                                backend, kind):
    got = [float(r[f"rays_{kind}_{backend}"]) for r in ranks[world]]
    assert got == [_slice_rays(scenes, backend, kind, world, rank)
                   for rank in range(world)]
    cam, by_backend = scenes
    spp = SPP_TILE if kind == "tile" else SPP_SAMPLE
    _, whole = get_tracer(backend)(by_backend[backend], cam, 1,
                                   torch.zeros(2), W, H, spp, DEPTH,
                                   with_stats=True)
    assert sum(got) == float(whole) > W * H


@pytest.mark.parametrize("backend", BACKENDS)
def test_2d_ranks_last_rays_are_their_own_slices(ranks, scenes, backend):
    for r in ranks[4]:
        coord = tuple(int(c) for c in r["coord"])
        assert float(r[f"rays_tile_sample_{backend}"]) == _slice_rays(
            scenes, backend, "2d", 4, coord)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,world", [("tile", 2), ("tile", 4),
                                        ("sample", 2), ("sample", 4),
                                        ("tile_sample", 4)])
def test_accumulator_bit_equal_to_the_step_restated(ranks, kind, world,
                                                    backend):
    for r in ranks[world]:
        np.testing.assert_array_equal(
            r[f"{kind}_{backend}"].view(np.int32),
            r[f"hand_{kind}_{backend}"].view(np.int32))


@pytest.mark.parametrize("world", [2, 4])
def test_step_launches_count_one_all_reduce_a_call(ranks, world):
    for r in ranks[world]:
        for b in BACKENDS:
            assert int(r[f"all_reduce_tile_{b}"]) == 0
            assert int(r[f"all_reduce_sample_{b}"]) == 1
            if world == 4:
                assert int(r[f"all_reduce_tile_sample_{b}"]) == 1


# -- the 4-rank BVH sample step under the benchmark's output check ------------

def _bench_snapshots(four, case) -> list:
    """Rank 0's snapshots of CHECK_FRAMES of `case` ("ok" or a fault) as
    the benchmark's sharded loop takes them: streams, jitter, every rank's
    sums and the rays summed."""
    snaps = []
    for f in CHECK_FRAMES:
        key = f"check_{case}_{{}}_{f}".format
        snaps.append(dict(
            frame=f, pixels=torch.arange(CHECK_W * CHECK_H),
            before=torch.from_numpy(four[0][key("before")]),
            after=torch.from_numpy(four[0][key("after")]),
            rays=sum(float(r[key("rays")]) for r in four), time=0.0,
            streams=[f * CHECK_SPP + i for i in range(CHECK_SPP)],
            jitter=pt.frame_jitter(f, CHECK_W, CHECK_H),
            rank_sums=[r[key("sum")].tolist() for r in four]))
    return snaps


def _bench_check(four, case="ok", control=False) -> tuple:
    with open(BENCH_CONFIG) as f:
        cfg = dict(json.load(f), width=CHECK_W, height=CHECK_H,
                   max_depth=CHECK_DEPTH)
    with open(BENCH_LIMITS) as f:
        limits = json.load(f)
    numbers, facts = check.check(SimpleNamespace(
        snapshots=_bench_snapshots(four, case)), cfg, "cpu", control=control)
    assert set(numbers) == set(limits)
    return numbers, limits, facts


def test_four_rank_bvh_sample_step_passes_the_benchmark_check(ranks):
    numbers, limits, facts = _bench_check(ranks[4])
    assert facts["checked"] == len(CHECK_FRAMES) * CHECK_W * CHECK_H
    assert all(v == 0.0 for v in numbers.values()), numbers
    assert all(v <= limits[k] for k, v in numbers.items())


def test_four_rank_bvh_sample_step_control_fails_the_check(ranks):
    """The reference in bfloat16, in the program's place."""
    numbers, limits, _ = _bench_check(ranks[4], control=True)
    assert not all(v <= limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("fault", FAULTS)
def test_four_rank_bvh_sample_step_fault_fails_the_check(ranks, fault):
    """Each fault planted in the step (`torch_shard_worker.planted`) comes
    out not correct."""
    numbers, limits, _ = _bench_check(ranks[4], fault)
    assert not all(v <= limits[k] for k, v in numbers.items()), numbers


# -- spans and counters --------------------------------------------------------

def _newest_span_id() -> int:
    return max((s.id for s in spans()), default=0)


@pytest.mark.parametrize("kind,split", [("tile", False), ("sample", False),
                                        ("sample", True), ("2d", False),
                                        ("2d", True)])
def test_sharded_step_spans_and_counters(world_of_one, captured, kind,
                                         split):
    """Two calls under `tracing()`: a `sharded.step` span a call (frame id
    the frame count) holding `sharded.inputs` and, on the split path,
    `sharded.all_reduce`; `sharded_steps` 2, `all_reduce_bytes` the
    (H*W, 3) f32 shares twice where a group reduces, `kernels.launches`
    one all-reduce a call there; `last_rays` the call's own count. A third
    call with tracing off records no span and still counts."""
    cam, by_backend = shard_scenes()
    step = _make(kind, world_of_one)
    step.steps, step.split = CapturedSteps("cpu"), split
    acc = torch.zeros((W * H, 4))
    reduces = kind != "tile"
    first = _newest_span_id()
    before, launched = counters(), kernels.launches["all_reduce"]
    with tracing():
        for f in (1, 2):
            step(by_backend["bvh"], cam, f, torch.zeros(2), acc)
    new = [s for s in spans() if s.id > first]
    outer = [s for s in new if s.name == "sharded.step"]
    assert [s.frame for s in outer] == [1, 2]
    assert all(s.parent == 0 for s in outer)
    for name in ("sharded.inputs", "sharded.all_reduce"):
        inner = [s for s in new if s.name == name]
        assert len(inner) == (0 if name == "sharded.all_reduce" and not split
                              else 2), name
        assert [s.parent for s in inner] == [s.id for s in outer][
            :len(inner)]
        assert [s.frame for s in inner] == [1, 2][:len(inner)]
    after = counters()
    assert after["sharded_steps"] - before.get("sharded_steps", 0) == 2
    assert after.get("all_reduce_bytes", 0) \
        - before.get("all_reduce_bytes", 0) == 2 * reduces * W * H * 3 * 4
    assert kernels.launches["all_reduce"] - launched == 2 * reduces
    spp = SPP_TILE if kind == "tile" else 2
    _, rays = get_tracer("bvh")(by_backend["bvh"], cam, 2, torch.zeros(2), W,
                                H, spp, DEPTH, with_stats=True)
    assert float(step.last_rays) == float(rays)

    first = _newest_span_id()
    step(by_backend["bvh"], cam, 3, torch.zeros(2), acc)
    assert _newest_span_id() == first
    assert counters()["sharded_steps"] - after["sharded_steps"] == 1
