"""The port's main path against the JAX package, end to end on the CPU.

- trace: the port's `trace_pixels_dense` (the row-state loop through the
  plain sweep and `shade_step`) against JAX `trace_pixels_dense`
  (`ray_color_dense`) on cornell 32^2 d5, frames 1..8. As in
  tests/test_shade_rows.py: >= 95% of lanes at rel < 1e-3 (winner
  near-ties flip paths), means within 2%, ray counts within 2%.
- goldens: the port's mean radiance of every untextured preset within
  tests/test_golden.py's bounds (cornell 0.2597 +- 0.03, ...); the
  multi-tile presets run the sweep over many 128-tri tiles.
- present: the port's `postprocess` on the same accum/history: HDR history
  allclose at rtol 1e-5, LDR within 1 code and equal on >= 99%.
- Renderer: CPU frames are finite; "cuda" raises without a card; a
  textured scene and one over 16384 world tris raise NotImplementedError.
- the package imports no JAX.
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.dense_trace import \
    trace_pixels_dense as jax_trace
from webgpu_raytracer_tpu.ops.postprocess import \
    postprocess as jax_postprocess
from webgpu_raytracer_tpu.render.resources import build_device_scene
from webgpu_raytracer_tpu_torch import (NativeWorld, Renderer, RenderConfig,
                                        kernels)
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu_torch.ops.postprocess import postprocess
from webgpu_raytracer_tpu_torch.ops.trace import accumulate
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables

from tests.glb_fixture import textured_quad_glb
from tests.test_golden import GOLDEN
from tests.torch_common import jax_and_port_tables

RES, DEPTH, FRAMES = 32, 5, 8


@pytest.fixture(scope="module")
def cornell_frames():
    """Per frame: (JAX col, JAX rays, port col, port rays)."""
    world, wt, tables = jax_and_port_tables("cornell", RES)
    scene = build_device_scene(world)
    cam = np.asarray(world.camera(), np.float32)
    out = []
    for f in range(1, FRAMES + 1):
        col_j, rays_j = jax_trace(wt, scene.textures, jnp.asarray(cam),
                                  jnp.asarray(f, jnp.int32),
                                  jnp.zeros(2, jnp.float32), RES, RES, 1,
                                  DEPTH, with_stats=True)
        col_t, rays_t = trace_pixels_dense(
            tables, torch.from_numpy(cam), f, torch.zeros(2), RES, RES, 1,
            DEPTH, with_stats=True)
        out.append((np.asarray(col_j), float(rays_j), col_t.numpy(),
                    float(rays_t)))
    return out


@pytest.mark.parametrize("frame", range(1, FRAMES + 1))
def test_trace_matches_jax(cornell_frames, frame):
    a, rays_a, b, rays_b = cornell_frames[frame - 1]
    assert b.shape == (RES * RES, 3) and np.isfinite(b).all()
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    frac = (rel < 1e-3).mean()
    assert frac >= 0.95, f"{frac:.3%} lanes match"
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3)
    assert abs(rays_a - rays_b) <= 0.02 * rays_a


@pytest.mark.parametrize("case", ["cornell", "viewer", "mixed", "special",
                                  "mesh"])
def test_golden_mean_radiance(case):
    scene_name, depth, frames, res, _, _, expected, tol = GOLDEN[case]
    world = NativeWorld(scene_name)
    world.update_camera(res, res)
    tables = build_world_tables(world, "cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    mean = np.mean([
        trace_pixels_dense(tables, cam, f, torch.zeros(2), res, res, 1,
                           depth).mean().item()
        for f in range(1, frames + 1)])
    assert abs(mean - expected) < tol, (case, mean, expected, tol)


def test_accumulate_resets_at_frame_one():
    prev = torch.full((4, 4), 7.0)
    col = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    np.testing.assert_array_equal(accumulate(prev, col, 1)[:, :3], col)
    np.testing.assert_array_equal(accumulate(prev, col, 2)[:, 3], 8.0)


@pytest.mark.parametrize("frame_count,jitter", [
    (1, (0.0, 0.0)), (4, (0.01, -0.02)), (16, (-0.03, 0.015)),
    (40, (0.0, 0.0))])
def test_postprocess_matches_jax(frame_count, jitter):
    rs = np.random.default_rng(frame_count)
    H, W = 24, 40
    acc = np.abs(rs.normal(0.4, 0.3, size=(H, W, 4))).astype(np.float32)
    acc[..., 3] = frame_count
    acc[3, 5, :3] = 60.0  # a firefly
    hist = np.abs(rs.normal(0.4, 0.1, size=(H, W, 3))).astype(np.float32)
    jit = np.asarray(jitter, np.float32)
    ldr_j, hdr_j = jax_postprocess(jnp.asarray(acc), jnp.asarray(hist),
                                   jnp.asarray(frame_count, jnp.int32),
                                   jnp.asarray(jit))
    ldr_t, hdr_t = postprocess(torch.from_numpy(acc), torch.from_numpy(hist),
                               frame_count, torch.from_numpy(jit))
    np.testing.assert_allclose(hdr_t.numpy(), np.asarray(hdr_j), rtol=1e-5,
                               atol=1e-6)
    ldr_j = np.asarray(ldr_j).astype(np.int32)
    ldr_t = ldr_t.numpy()
    assert ldr_t.dtype == np.uint8 and ldr_t.shape == (H, W, 3)
    assert np.abs(ldr_t.astype(np.int32) - ldr_j).max() <= 1
    assert (ldr_t == ldr_j).mean() >= 0.99


def test_renderer_cpu_frames_and_present():
    r = Renderer("cornell", RenderConfig(width=32, height=24, max_depth=4),
                 device="cpu")
    for _ in range(4):
        r.render_frame()
        img = r.present()
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8
    assert 0 < img.mean() < 255
    rad = r.radiance()
    assert rad.shape == (24, 32, 3) and np.isfinite(rad).all()
    assert float(r.last_rays) >= 32 * 24
    assert r.launches == {k: 0 for k in kernels.launches}  # plain on CPU
    r.build_pipeline(3, 1)
    assert r.frame_count == 0 and float(r.history.abs().sum()) == 0.0
    r.update_scene(0.0)
    r.render_frame()
    assert np.isfinite(r.radiance()).all()


def test_renderer_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer("cornell", RenderConfig(width=8, height=8))


def test_renderer_textured_scene_not_ported():
    with pytest.raises(NotImplementedError, match="textured"):
        Renderer("viewer", RenderConfig(width=8, height=8),
                 glb_data=textured_quad_glb(), device="cpu")


def test_renderer_large_scene_not_ported():
    """Over the dense limit (spheres: ~257k world tris) the JAX package
    takes its BVH path, which the port does not have yet."""
    with pytest.raises(NotImplementedError, match="16384"):
        Renderer("spheres", RenderConfig(width=8, height=8), device="cpu")


def test_package_imports_no_jax():
    code = ("import webgpu_raytracer_tpu_torch, "
            "webgpu_raytracer_tpu_torch.render.renderer\n"
            "import webgpu_raytracer_tpu_torch.kernels\n"
            "import sys; assert 'jax' not in sys.modules, 'jax imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
