"""The port's main path against the JAX package, end to end on the CPU.

- trace: the port's `trace_pixels_dense` (the row-state loop through the
  plain sweep and `shade_step`) against JAX `trace_pixels_dense`
  (`ray_color_dense`) on cornell 32^2 d5, frames 1..8. As in
  tests/test_shade_rows.py: >= 95% of lanes at rel < 1e-3 (winner
  near-ties flip paths), means within 2%, ray counts within 2%.
- the same tolerance on the second slice's paths, frames 1..4: the
  textured quad at 32^2 d4 and the character GLB (1294 tris over 11 tiles,
  2 textures, an emissive-textured collar, a metallic head) at 16^2 d3
  through the port's row-state loop, whose `shade_step` samples the
  textures (JAX traces them with its per-ray `ray_color_dense`), each
  package with its own decode;
  G-buffer-seeded cornell at 32^2 d4, each seeded from its own G-buffer;
  and `tests/torch_scenes.py`'s texture formats scene at 32^2 d4 (a 4:2:0
  and a progressive JPEG, a 16-bit Adam7 PNG and a 4-bit palette PNG in
  the base, metal-rough, normal and emissive slots; Pillow in JAX).
  The textured quad's mean at 64^2 d8 over 4 frames within 2% of JAX's.
  And on the third slice's: `spheres` (257,136 tris over 2,009 tiles) at
  16^2 d3, frames 1..2. And on the fourth's: mixed (35 tiles) at 32^2 d4
  through `narrow="scan"`, frames 1..2, bit-equal to the `narrow="jobs"`
  frames and within the same tolerance of the JAX frames traced with
  `TuneConfig(narrow="scan")`.
- goldens: the port's mean radiance of every untextured preset within
  tests/test_golden.py's bounds (cornell 0.2597 +- 0.03, ..., spheres
  0.0382 +- 0.006). Every multi-tile scene (the character GLB, viewer,
  mixed, special, mesh, spheres) sweeps through the job-stream path's
  plain versions: coherence sort, exact cull, per-group worklists.
- present: the port's `postprocess` on the same accum/history: HDR history
  allclose at rtol 1e-5, LDR within 1 code and equal on >= 99%.
- a textured scene at max_depth > 0 takes the row-state loop, and at
  max_depth 0 the port's `ray_color_dense`, traced and G-buffer seeded.
- Renderer: CPU frames are finite, for cornell and for mixed through the
  job-stream path and, with `narrow="scan"`, the scan path (the same
  accumulator bit for bit; an unknown narrow phase raises); "cuda" raises
  without a card; a textured scene renders and presents, and
  `render_frame(use_gbuffer=True)` gives the traced frame while counting
  the G-buffer's W*H rays in place of the primaries; on the CPU a scene
  over 16384 world tris renders through the BVH path.
- the package imports no JAX and loads no file of the JAX package: a fresh
  process renders a CPU frame, and its scene compiler is the port's own
  build.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.dense_trace import \
    trace_pixels_dense as jax_trace
from webgpu_raytracer_tpu.ops.gbuffer import render_gbuffer as jax_gbuffer
from webgpu_raytracer_tpu.ops.postprocess import \
    postprocess as jax_postprocess
from webgpu_raytracer_tpu.ops.tune import TuneConfig as JaxTune
from webgpu_raytracer_tpu.render.resources import build_device_scene
from webgpu_raytracer_tpu.utils import textures as jax_textures
from webgpu_raytracer_tpu_torch import (NativeWorld, Renderer, RenderConfig,
                                        kernels)
from webgpu_raytracer_tpu_torch.models import native
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
from webgpu_raytracer_tpu_torch.ops.gbuffer import render_gbuffer
from webgpu_raytracer_tpu_torch.ops.postprocess import postprocess
from webgpu_raytracer_tpu_torch.ops.trace import accumulate
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables
from webgpu_raytracer_tpu_torch.utils import textures as port_textures
from webgpu_raytracer_tpu_torch.utils.halton import frame_jitter

from tests import torch_scenes
from tests.glb_fixture import character_glb, textured_quad_glb
from tests.test_golden import GOLDEN
from tests.torch_common import jax_and_port_tables

RES, DEPTH, FRAMES = 32, 5, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The second slice's frames: name -> (scene, GLB, res, depth, seeded).
SLICE2 = {"textured": ("viewer", textured_quad_glb, 32, 4, False),
          "character": ("viewer", character_glb, 16, 3, False),
          "cornell_seeded": ("cornell", None, 32, 4, True),
          "formats": ("viewer", torch_scenes.formats_scene_glb, 32, 4,
                      False)}
SLICE2_FRAMES = 4
# The third slice's: multi-tile scenes through the job-stream path.
SLICE3 = {"spheres": ("spheres", None, 16, 3, False)}
SLICE3_FRAMES = 2
# The fourth slice's: a multi-tile scene through the scan path.
SLICE4 = {"mixed": ("mixed", None, 32, 4, False)}
SLICE4_FRAMES = 2
# max_depth 0: a scene of the row-state loop and a textured one.
DEPTH0 = {"cornell_d0": ("cornell", None, 16, 0, False),
          "textured_d0": ("viewer", textured_quad_glb, 16, 0, False)}
DEPTH0_FRAMES = 2
_jax_trace = jax.jit(jax_trace, static_argnames=(
    "width", "height", "spp", "max_depth", "with_stats", "tune"))


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


def _both_textures(world):
    """(JAX texture operand, port pyramid), each package decoding the
    world's images itself (the white placeholder / None when it has
    none)."""
    dec = jax_textures.decode_world_textures(world)
    if dec is None:
        jtex = jnp.ones((1, 1, 1, 3), jnp.float32)
    else:
        jtex = jax_textures.device_pyramid(jax_textures.build_quad_pyramid(dec))
        jtex = jtex[0] if jtex[1] is jtex[0] else jtex
    dec = port_textures.decode_world_textures(world)
    ptex = None if dec is None else device_pyramid(
        port_textures.build_quad_pyramid(dec), "cpu")
    return jtex, ptex


def _slice2_frames(case, frames, res=None, depth=None, narrow="jobs"):
    """Per frame: (JAX col, JAX rays, port col, port rays), both packages
    with the narrow phase `narrow`."""
    scene_name, glb, res0, depth0, seeded = {**SLICE2, **SLICE3, **SLICE4,
                                             **DEPTH0}[case]
    res, depth = res or res0, depth or depth0
    world, wt, tables = jax_and_port_tables(scene_name, res,
                                            glb() if glb else None)
    jtex, ptex = _both_textures(world)
    cam = np.asarray(world.camera(), np.float32)
    jseed = pseed = None
    if seeded:
        jseed = jax_gbuffer(wt, jtex, jnp.asarray(cam), res, res) \
            .wt_idx.reshape(-1)
        pseed = render_gbuffer(tables, ptex, torch.from_numpy(cam), res,
                               res).wt_idx.reshape(-1)
    out = []
    for f in range(1, frames + 1):
        col_j, rays_j = _jax_trace(wt, jtex, jnp.asarray(cam),
                                   jnp.asarray(f, jnp.int32),
                                   jnp.zeros(2, jnp.float32), width=res,
                                   height=res, spp=1, max_depth=depth,
                                   with_stats=True, seed_wt_idx=jseed,
                                   tune=JaxTune(narrow=narrow))
        col_t, rays_t = trace_pixels_dense(
            tables, torch.from_numpy(cam), f, torch.zeros(2), res, res, 1,
            depth, with_stats=True, textures=ptex, seed_wt_idx=pseed,
            narrow=narrow)
        out.append((np.asarray(col_j), float(rays_j), col_t.numpy(),
                    float(rays_t)))
    return out


@pytest.fixture(scope="module", params=sorted(SLICE2))
def slice2_frames(request):
    return request.param, _slice2_frames(request.param, SLICE2_FRAMES)


@pytest.mark.parametrize("frame", range(1, SLICE2_FRAMES + 1))
def test_slice2_trace_matches_jax(slice2_frames, frame):
    """Textured, character and seeded frames: the cornell tolerance."""
    case, per_frame = slice2_frames
    a, rays_a, b, rays_b = per_frame[frame - 1]
    assert b.shape == a.shape and np.isfinite(b).all(), case
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    frac = (rel < 1e-3).mean()
    assert frac >= 0.95, f"{case}: {frac:.3%} lanes match"
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3), case
    assert abs(rays_a - rays_b) <= 0.02 * rays_a, case


@pytest.fixture(scope="module")
def spheres_frames():
    return _slice2_frames("spheres", SLICE3_FRAMES)


@pytest.mark.parametrize("frame", range(1, SLICE3_FRAMES + 1))
def test_spheres_trace_matches_jax(spheres_frames, frame):
    """spheres 16^2 d3 through the job-stream path: the cornell
    tolerance."""
    a, rays_a, b, rays_b = spheres_frames[frame - 1]
    assert b.shape == a.shape and np.isfinite(b).all()
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    frac = (rel < 1e-3).mean()
    assert frac >= 0.95, f"{frac:.3%} lanes match"
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3)
    assert abs(rays_a - rays_b) <= 0.02 * rays_a


@pytest.fixture(scope="module")
def scan_frames():
    return (_slice2_frames("mixed", SLICE4_FRAMES, narrow="scan"),
            _slice2_frames("mixed", SLICE4_FRAMES, narrow="jobs"))


@pytest.mark.parametrize("frame", range(1, SLICE4_FRAMES + 1))
def test_scan_trace_bit_equal_to_jobs_and_matches_jax(scan_frames, frame):
    """mixed 32^2 d4 through the scan path: the job path's frame bit for
    bit (both narrow phases give the full sweep's hits), and the cornell
    tolerance against JAX."""
    a, rays_a, b, rays_b = scan_frames[0][frame - 1]
    _, _, b_jobs, rays_jobs = scan_frames[1][frame - 1]
    np.testing.assert_array_equal(b.view(np.int32), b_jobs.view(np.int32))
    assert rays_b == rays_jobs
    assert b.shape == a.shape and np.isfinite(b).all() and b.mean() > 0.01
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    frac = (rel < 1e-3).mean()
    assert frac >= 0.95, f"{frac:.3%} lanes match"
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3)
    assert abs(rays_a - rays_b) <= 0.02 * rays_a


@pytest.mark.parametrize("case", sorted(DEPTH0))
def test_max_depth_zero_matches_jax(case):
    """max_depth=0: the JAX loop still runs its last, shadow-only bounce
    (at depth -1), so lights seen directly and the first hit's NEE light
    the frame; the port does the same on both loops' scenes (cornell is a
    row-state scene). The cornell tolerance, frames 1..2, and light
    there."""
    for a, rays_a, b, rays_b in _slice2_frames(case, DEPTH0_FRAMES):
        assert b.shape == a.shape and np.isfinite(b).all()
        assert a.mean() > 0.01 and rays_a > 16 * 16
        rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
        frac = (rel < 1e-3).mean()
        assert frac >= 0.95, f"{frac:.3%} lanes match"
        assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3)
        assert abs(rays_a - rays_b) <= 0.02 * rays_a


def test_textured_mean_64_d8_matches_jax():
    """bench.py's textured config at 64^2 (its 1080p golden 0.2739 belongs
    to the 16:9 frame): 4 frames, means within 2%."""
    per_frame = _slice2_frames("textured", 4, res=64, depth=8)
    mean_j = np.mean([a.mean() for a, _, _, _ in per_frame])
    mean_t = np.mean([b.mean() for _, _, b, _ in per_frame])
    assert 0.3 < mean_j < 0.7
    assert abs(mean_t - mean_j) < 0.02 * mean_j, (mean_t, mean_j)


@pytest.mark.parametrize("case", ["cornell", "viewer", "mixed", "special",
                                  "mesh", "spheres"])
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
    """accumulate writes into the accumulator it is given (the JAX
    package's donated buffer), so each call gets its own copy."""
    prev = torch.full((4, 4), 7.0)
    col = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    np.testing.assert_array_equal(accumulate(prev.clone(), col, 1)[:, :3],
                                  col)
    np.testing.assert_array_equal(accumulate(prev.clone(), col, 2)[:, 3],
                                  8.0)


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
    r = Renderer("cornell",
                 config=RenderConfig(width=32, height=24, max_depth=4),
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


def test_renderer_multi_tile_cpu_frames():
    """mixed (35 tiles) renders finite frames through the job-stream
    path's plain versions."""
    r = Renderer("mixed",
                 config=RenderConfig(width=32, height=32, max_depth=4),
                 device="cpu")
    assert r.tables.spheres.shape == (35, 4)
    for _ in range(2):
        r.render_frame()
        img = r.present()
    assert img.shape == (32, 32, 3) and 0 < img.mean() < 255
    assert np.isfinite(r.radiance()).all()
    assert r.launches == {k: 0 for k in kernels.launches}  # plain on CPU


def test_renderer_scan_cpu_frames():
    """`Renderer(..., narrow="scan")` renders mixed through the scan path's
    plain versions, to the accumulator of the default Renderer bit for
    bit; an unknown narrow phase raises at construction."""
    cfg = dict(width=32, height=32, max_depth=4)
    scan = Renderer("mixed", config=RenderConfig(**cfg), device="cpu",
                    narrow="scan")
    jobs = Renderer("mixed", config=RenderConfig(**cfg), device="cpu")
    assert (scan.narrow, jobs.narrow) == ("scan", "jobs")
    for _ in range(2):
        scan.render_frame()
        jobs.render_frame()
        img = scan.present()
    assert img.shape == (32, 32, 3) and 0 < img.mean() < 255
    assert np.isfinite(scan.radiance()).all()
    assert torch.equal(scan.accum.view(torch.int32),
                       jobs.accum.view(torch.int32))
    assert float(scan.last_rays) == float(jobs.last_rays)
    assert scan.launches == {k: 0 for k in kernels.launches}  # plain on CPU
    with pytest.raises(ValueError, match="narrow"):
        Renderer("mixed",
                 config=RenderConfig(**cfg), device="cpu", narrow="bogus")
    with pytest.raises(ValueError, match="narrow"):
        Renderer("cornell", config=RenderConfig(**cfg), device="cpu",
                 narrow="bogus")


def test_renderer_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer("cornell", config=RenderConfig(width=8, height=8))


def test_renderer_textured_frames_and_gbuffer_seeding():
    """A textured Renderer on the CPU renders and presents the red/blue
    quad. With use_gbuffer=True (lens radius 0) each frame equals the
    traced one, and its ray count adds the G-buffer's W*H rays to the
    seeded trace's, in place of the traced frame's primaries."""
    W, H = 32, 24
    glb = textured_quad_glb()
    traced, seeded = (Renderer("viewer", config=RenderConfig(width=W, height=H,
                                                      max_depth=4),
                               glb_data=glb, device="cpu")
                      for _ in range(2))
    assert traced.textures[0].shape == (1, 1024, 1024)
    assert traced.textures[1].shape == (1, 128, 128)
    assert float(traced.camera[3]) == 0.0
    for _ in range(3):
        traced.render_frame()
        img = traced.present()
        seeded.render_frame(use_gbuffer=True)
        img_s = seeded.present()
        assert torch.equal(seeded.accum, traced.accum)
        np.testing.assert_array_equal(img_s, img)
        assert float(seeded.last_rays) == float(traced.last_rays)
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    rad = seeded.radiance()
    assert np.isfinite(rad).all()
    red = (rad[..., 0] > 4 * rad[..., 2]).mean()
    blue = (rad[..., 2] > 4 * rad[..., 0]).mean()
    assert red > 0.02 and blue > 0.02, (red, blue)  # not the 0.8 grey
    assert seeded.launches == {k: 0 for k in kernels.launches}
    jitter = torch.from_numpy(frame_jitter(4, W, H))
    seed = render_gbuffer(seeded.tables, seeded.textures, seeded.camera, W,
                          H, jitter=jitter).wt_idx.reshape(-1)
    seeded.render_frame(use_gbuffer=True)
    _, rays = trace_pixels_dense(seeded.tables, seeded.camera, 4, jitter, W,
                                 H, 1, 4, with_stats=True,
                                 textures=seeded.textures, seed_wt_idx=seed)
    assert float(seeded.last_rays) == float(rays) + W * H


@pytest.mark.parametrize("depth", [0, 2])
def test_textured_trace_takes_rows_loop(monkeypatch, depth):
    """trace_pixels_dense on the textured quad calls ray_color_dense_rows
    at max_depth > 0 and ray_color_dense only at max_depth 0 (its one
    shadow-only last bounce), traced and seeded from a G-buffer."""
    from webgpu_raytracer_tpu_torch.ops import dense_trace as pdt

    world = NativeWorld("viewer", glb_data=textured_quad_glb())
    world.update_camera(8, 8)
    tables = build_world_tables(world, "cpu")
    ptex = device_pyramid(port_textures.build_quad_pyramid(
        port_textures.decode_world_textures(world)), "cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    calls = []
    for name in ("ray_color_dense", "ray_color_dense_rows"):
        def counted(*args, _fn=getattr(pdt, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(pdt, name, counted)
    seed = render_gbuffer(tables, ptex, cam, 8, 8).wt_idx.reshape(-1)
    for s in (None, seed):
        col = trace_pixels_dense(tables, cam, 1, torch.zeros(2), 8, 8, 1,
                                 depth, textures=ptex, seed_wt_idx=s)
        assert torch.isfinite(col).all() and float(col.mean()) > 0.01
    want = "ray_color_dense_rows" if depth > 0 else "ray_color_dense"
    assert calls == [want, want]


def test_renderer_large_scene_not_ported():
    """On the CPU, over the dense limit (spheres: ~257k world tris) the
    port takes the BVH path, as the JAX package does (the name is from
    before that path was ported): 8x8 d2 frames are finite and not black.
    (On CUDA the port's dense path takes spheres:
    tests/test_torch_cuda.py.)"""
    r = Renderer("spheres", config=RenderConfig(width=8, height=8,
                                                max_depth=2), device="cpu")
    assert r.backend == "bvh" and r.tables is None
    for _ in range(2):
        r.render_frame()
        img = r.present()
    assert img.shape == (8, 8, 3) and img.max() > 0
    rad = r.radiance()
    assert np.isfinite(rad).all() and rad.max() > 0
    assert float(r.last_rays) >= 64
    assert r.launches == {k: 0 for k in kernels.launches}  # plain on CPU


def test_package_imports_no_jax():
    """A fresh process imports the port (its CLI, recorder, checkpoint,
    preview, farm, JPEG decoder and profiling modules too), builds a
    world, renders a CPU frame and records one through `record_chunks`: no
    JAX, no Pillow, no module of the JAX package, and the scene compiler
    mapped from the port's own build directory."""
    code = textwrap.dedent('''
        import os, sys
        import webgpu_raytracer_tpu_torch as port
        import webgpu_raytracer_tpu_torch.kernels
        from webgpu_raytracer_tpu_torch import cli
        from webgpu_raytracer_tpu_torch.models import native
        from webgpu_raytracer_tpu_torch.ops import api, bsdf, intersect, trace
        from webgpu_raytracer_tpu_torch.parallel import cluster, sharding
        from webgpu_raytracer_tpu_torch.render import resources
        from webgpu_raytracer_tpu_torch.render import (checkpoint, preview,
                                                       recorder)
        from webgpu_raytracer_tpu_torch.utils import jpeg, profiling
        world = port.NativeWorld("cornell")
        cfg = port.RenderConfig(width=8, height=8, max_depth=2, spp=1)
        r = port.Renderer("cornell", config=cfg, device="cpu")
        r.render_frame()
        assert r.present().shape == (8, 8, 3)
        frames = recorder.VideoRecorder(r).record_chunks(cfg, 0, 1)
        assert len(frames) == 1 and frames[0].data.startswith(b"\\x89PNG")
        assert "jax" not in sys.modules, "jax imported"
        assert "PIL" not in sys.modules, "PIL imported"
        jax_pkg = os.path.join(sys.argv[1], "webgpu_raytracer_tpu", "")
        for name, mod in list(sys.modules.items()):
            path = os.path.abspath(getattr(mod, "__file__", None) or "/")
            assert not path.startswith(jax_pkg), (name, path)
        with open("/proc/self/maps") as f:
            libs = {line.split()[-1] for line in f if "libscene" in line}
        assert libs, "no libscene mapped"
        for lib in libs:
            assert os.path.dirname(lib) == native.BUILD_DIR, lib
        print(sorted(libs))
    ''')
    proc = subprocess.run([sys.executable, "-c", code, REPO],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "webgpu_raytracer_tpu_torch/build/libscene_" in proc.stdout
