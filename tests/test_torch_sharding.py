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
"""

import os
import socket
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.models.native import NativeWorld as JaxWorld
from webgpu_raytracer_tpu.ops.trace import trace_pixels as jax_trace
from webgpu_raytracer_tpu.render.resources import \
    build_device_scene as jax_scene
from webgpu_raytracer_tpu_torch.ops.api import get_tracer
from webgpu_raytracer_tpu_torch.ops.trace import accumulate

from tests.torch_shard_worker import (BACKENDS, DEPTH, H, SPP_2D,
                                      SPP_SAMPLE, SPP_TILE, W, shard_scenes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_shard_worker.py")
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
