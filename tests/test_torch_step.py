"""The port's frame steps against the JAX package's, on the CPU.

- `render_step` / `present_step` (render/renderer.py) against the JAX
  package's jitted `render_step` / `present_step` on the same inputs:
  cornell 32x24 d4 dense, the same seeded from its G-buffer
  (`use_gbuffer=True`), and `backend="bvh"`, frames 1, 2 and 17, with the
  tolerance tests/test_torch_slice.py holds frames to (>= 95% of lanes at
  rel < 1e-3, means and ray counts within 2%) and the one it holds
  `postprocess` to (HDR at rtol 1e-5, LDR within 1 code, equal on >= 99%)
  for frames 1, 2, 16, 17 and 40. The sample count column is exact: frame 1
  overwrites the accumulator it is given.
- A frame count given as a 0-d tensor gives the same bits as the int in
  `init_rng` (a frame whose seed wraps past 2**32 included, and the JAX
  package's u32 words), `trace_pixels_dense`, `trace_pixels`,
  `accumulate` and `postprocess` (past frame 16 also with the resample
  skipped, `unjitter=False`).
- The step key (`step_key`, `Renderer.render_key`) changes on
  `build_pipeline`, on a resize and on tables whose light count differs,
  and not on a reupload of equal shapes; two steps of one name have two
  keys.
- `CapturedSteps` on the CPU, with its graph recording replaced by a
  stand-in that replays the step eagerly on the graph's own argument
  tensors and writes its outputs into the graph's output tensors (what a
  CUDA graph does): a `Renderer` through it gives the eager `Renderer`'s
  accumulator, image and ray count bit for bit over 18 frames, across a
  `build_pipeline`, a resize, the skinned strip's equal-shape reuploads
  and a checkpoint load; one capture per key, none on an equal-shape
  reupload, the entries of an old size dropped; a BVH scene reuploaded
  with other values gets its packs rebuilt into the graph's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.models.native import NativeWorld as JaxWorld
from webgpu_raytracer_tpu.ops.rng import init_rng as jax_init_rng
from webgpu_raytracer_tpu.render.renderer import \
    present_step as jax_present_step
from webgpu_raytracer_tpu.render.renderer import \
    render_step as jax_render_step
from webgpu_raytracer_tpu.render.resources import \
    build_device_scene as jax_scene
from webgpu_raytracer_tpu.render.worldtris import build_world_tris
from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu_torch.ops.postprocess import postprocess
from webgpu_raytracer_tpu_torch.ops.rng import init_rng
from webgpu_raytracer_tpu_torch.ops.trace import (accumulate, scene_packs,
                                                  trace_pixels)
from webgpu_raytracer_tpu_torch.render import renderer as prr
from webgpu_raytracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                        present_step,
                                                        render_step,
                                                        step_key)
from webgpu_raytracer_tpu_torch.render.resources import build_device_scene
from webgpu_raytracer_tpu_torch.render.worldtris import tables_from_jax
from webgpu_raytracer_tpu_torch.utils.halton import frame_jitter

from tests.torch_common import record_eagerly

from tests import torch_scenes
from tests.glb_fixture import skinned_strip_glb

W, H, DEPTH = 32, 24, 4
FRAMES = (1, 2, 17)
PRESENT_FRAMES = (1, 2, 16, 17, 40)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


# -- render_step / present_step against the JAX package -----------------------

@pytest.fixture(scope="module")
def cornell():
    """(JAX WorldTris, JAX DeviceScene, port tables, port DeviceScene,
    camera) of cornell at W x H."""
    jw, pw = JaxWorld("cornell"), NativeWorld("cornell")
    for w in (jw, pw):
        w.update_camera(W, H)
    wt = build_world_tris(jw)
    tables = tables_from_jax({k: np.asarray(v)
                              for k, v in wt._asdict().items()})
    return (wt, jax_scene(jw), tables, build_device_scene(pw, device="cpu"),
            np.asarray(jw.camera(), np.float32))


def _prev(frame):
    """The accumulator a frame is given: 7.0 everywhere before frame 1
    (which must overwrite it), else no radiance yet and frame - 1
    samples, so the output's radiance is the frame's own."""
    prev = np.zeros((W * H, 4), np.float32)
    if frame == 1:
        prev[:] = 7.0
    else:
        prev[:, 3] = frame - 1
    return prev


def _both_steps(cornell, case, frame):
    wt, jscene, tables, pscene, cam = cornell
    jit = frame_jitter(frame, W, H)
    prev = _prev(frame)
    static = dict(width=W, height=H, spp=1, max_depth=DEPTH,
                  use_gbuffer=case == "seeded")
    if case == "bvh":
        jarg, parg, static["backend"] = jscene, pscene, "bvh"
    else:
        jarg, parg, static["backend"] = (wt, jscene.textures), \
            (tables, None), "dense"
    acc_j, rays_j = jax_render_step(jarg, jnp.asarray(cam),
                                    jnp.asarray(frame, jnp.int32),
                                    jnp.asarray(jit), jnp.asarray(prev),
                                    **static)
    accum = torch.from_numpy(prev.copy())
    acc_t, rays_t = render_step(parg, torch.from_numpy(cam),
                                torch.tensor(frame), torch.from_numpy(jit),
                                accum, **static)
    assert acc_t is accum  # written in place: the donated accumulator
    return np.asarray(acc_j), float(rays_j), acc_t.numpy(), float(rays_t)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("case", ["dense", "seeded", "bvh"])
def test_render_step_matches_jax(cornell, case, frame):
    a, rays_a, b, rays_b = _both_steps(cornell, case, frame)
    np.testing.assert_array_equal(b[:, 3], frame)
    np.testing.assert_array_equal(a[:, 3], frame)
    a, b = a[:, :3], b[:, :3]
    assert np.isfinite(b).all() and b.mean() > 0.05, case
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    frac = (rel < 1e-3).mean()
    assert frac >= 0.95, f"{case} frame {frame}: {frac:.3%} lanes match"
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3), case
    assert abs(rays_a - rays_b) <= 0.02 * rays_a, case


@pytest.mark.parametrize("frame", PRESENT_FRAMES)
def test_present_step_matches_jax(frame):
    rs = np.random.default_rng(frame)
    acc = np.abs(rs.normal(0.4, 0.3, size=(W * H, 4))).astype(np.float32)
    acc[:, 3] = frame
    acc[77, :3] = 60.0  # a firefly
    hist = np.abs(rs.normal(0.4, 0.1, size=(H, W, 3))).astype(np.float32)
    avg = np.asarray(rs.uniform(-0.5, 0.5, 2) / (W, H), np.float32)
    ldr_j, hdr_j = jax_present_step(jnp.asarray(acc), jnp.asarray(hist),
                                    jnp.asarray(frame, jnp.int32),
                                    jnp.asarray(avg), width=W, height=H)
    history = torch.from_numpy(hist.copy())
    ldr_t, hdr_t = present_step(torch.from_numpy(acc), history,
                                torch.tensor(frame), torch.from_numpy(avg),
                                width=W, height=H)
    assert hdr_t is history
    np.testing.assert_allclose(hdr_t.numpy(), np.asarray(hdr_j), rtol=1e-5,
                               atol=1e-6)
    ldr_j = np.asarray(ldr_j).astype(np.int32)
    ldr_t = ldr_t.numpy()
    assert ldr_t.dtype == np.uint8 and ldr_t.shape == (H, W, 3)
    assert np.abs(ldr_t.astype(np.int32) - ldr_j).max() <= 1
    assert (ldr_t == ldr_j).mean() >= 0.99


# -- a frame count on the device gives the int's bits ------------------------

@pytest.mark.parametrize("frame,total_spp,sample", [
    (1, 1, 0), (17, 4, 3), (2 ** 31 + 5, 4, 1), (2 ** 32 - 1, 1024, 7)])
def test_init_rng_frame_tensor_equals_int(frame, total_spp, sample):
    """The seed frame * total_spp + sample as the int and as the tensor the
    traces compute; the last two wrap past 2**32, as the JAX package's u32
    arithmetic does."""
    pix = torch.arange(4096, dtype=torch.int64) * 977
    seed_i = frame * total_spp + sample
    seed_t = torch.tensor(frame) * total_spp + sample
    a = init_rng(pix, seed_i)
    b = init_rng(pix, seed_t)
    assert torch.equal(a, b)
    want = jax_init_rng(jnp.asarray(pix.numpy().astype(np.uint32)),
                        jnp.uint32(frame % 2 ** 32) * jnp.uint32(total_spp)
                        + jnp.uint32(sample))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want).astype(np.int64))


def test_traces_frame_tensor_bit_equal(cornell):
    """trace_pixels_dense and trace_pixels: frame 17 as an int and as a
    0-d tensor give the same radiance and rays bit for bit (spp 2, so the
    seed's sample term is used)."""
    _, _, tables, pscene, cam = cornell
    cam = torch.from_numpy(cam)
    jit = torch.from_numpy(frame_jitter(17, W, H))
    for trace, scene in ((trace_pixels_dense, tables),
                         (trace_pixels, pscene)):
        a, ra = trace(scene, cam, 17, jit, W, H, 2, 3, with_stats=True)
        b, rb = trace(scene, cam, torch.tensor(17), jit, W, H, 2, 3,
                      with_stats=True)
        assert torch.equal(_bits(a), _bits(b)) and float(ra) == float(rb)


@pytest.mark.parametrize("frame", [1, 2, 17])
def test_accumulate_frame_tensor_bit_equal(frame):
    rs = np.random.default_rng(frame)
    prev = torch.from_numpy(rs.normal(size=(64, 4)).astype(np.float32))
    col = torch.from_numpy(rs.normal(size=(64, 3)).astype(np.float32))
    a = accumulate(prev.clone(), col, frame)
    b = accumulate(prev.clone(), col, torch.tensor(frame))
    assert torch.equal(_bits(a), _bits(b))
    want = torch.cat([col, torch.ones(64, 1)], 1)
    if frame > 1:
        want = prev + want
    assert torch.equal(_bits(a), _bits(want))


@pytest.mark.parametrize("frame", PRESENT_FRAMES)
def test_postprocess_frame_tensor_bit_equal(frame):
    rs = np.random.default_rng(frame)
    acc = torch.from_numpy(
        np.abs(rs.normal(0.4, 0.3, size=(H, W, 4))).astype(np.float32))
    hist = torch.from_numpy(
        np.abs(rs.normal(0.4, 0.1, size=(H, W, 3))).astype(np.float32))
    avg = torch.tensor([0.013, -0.021])
    a = postprocess(acc, hist, frame, avg)
    b = postprocess(acc, hist, torch.tensor(frame), avg)
    assert torch.equal(a[0], b[0]) and torch.equal(_bits(a[1]), _bits(b[1]))
    if frame > 16:  # past 16 the resample is not selected: skipping it
        c = postprocess(acc, hist, torch.tensor(frame), avg, unjitter=False)
        assert torch.equal(a[0], c[0]) and torch.equal(_bits(a[1]),
                                                       _bits(c[1]))


# -- the step key -------------------------------------------------------------

def test_step_key_follows_what_a_retrace_sees():
    r = Renderer("cornell", config=RenderConfig(width=16, height=12,
                                                max_depth=3), device="cpu")
    k0 = r.render_key()
    assert r.render_key() == k0
    assert r.render_key(use_gbuffer=True) != k0
    r.update_scene(0.0)  # a reupload of equal shapes
    assert r.render_key() == k0
    r.build_pipeline(4, 1)
    k1 = r.render_key()
    assert k1 != k0
    r.build_pipeline(3, 1)
    assert r.render_key() == k0
    r.update_screen_size(20, 12)
    assert r.render_key() != k0
    r.update_screen_size(16, 12)
    assert r.render_key() == k0
    lit = r.tables._replace(light_count=r.tables.light_count + 1)
    args = ((lit, None), r.camera, r._frame, r._jitter, r.accum)
    assert step_key(render_step, args, r._render_static(False)) != k0


def test_step_key_tells_apart_steps_of_one_name(captured):
    """Two steps of one `__name__` and one signature (as the sharded
    steps' bodies are) get two keys, and through one cache each replays
    its own graph."""
    def scaled(k):
        def step(x, *, width, height):
            return (x * k,)
        return step

    a, b = scaled(2.0), scaled(3.0)
    assert a.__name__ == b.__name__
    x, static = torch.ones(4), dict(width=2, height=2)
    assert step_key(a, (x,), static) == step_key(a, (x,), static)
    assert step_key(a, (x,), static) != step_key(b, (x,), static)
    steps = CapturedSteps("cpu")
    for _ in range(2):
        (ya,), _ = steps.run(a, (x,), static)
        (yb,), _ = steps.run(b, (x,), static)
        assert torch.equal(ya, x * 2.0) and torch.equal(yb, x * 3.0)
    assert len(steps.captures) == 2
    assert step_key(render_step, (x,), static) != step_key(a, (x,), static)


# -- the step cache, with a stand-in for the CUDA graph ----------------------

@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(CapturedSteps, "_record", record_eagerly)
    monkeypatch.setattr(prr.kernels, "library", lambda: None)


def _pair(name="cornell", glb=None, size=(16, 12), depth=3):
    cfg = dict(width=size[0], height=size[1], max_depth=depth)
    eager, graph = (Renderer(name, config=RenderConfig(**cfg), glb_data=glb,
                             device="cpu") for _ in range(2))
    graph.steps = CapturedSteps("cpu")
    return eager, graph


def _same_frames(eager, graph, n, use_gbuffer=False):
    for _ in range(n):
        a = eager.render_frame(use_gbuffer).clone()
        b = graph.render_frame(use_gbuffer).clone()
        assert torch.equal(_bits(a), _bits(b)), eager.frame_count
        assert float(eager.last_rays) == float(graph.last_rays)
        np.testing.assert_array_equal(eager.present(), graph.present())
        assert torch.equal(_bits(eager.history), _bits(graph.history))


def test_captured_renderer_equals_eager(captured, tmp_path):
    """18 frames (the resample's regime ends at 16), a build_pipeline, a
    resize, then a checkpoint load into a fresh captured Renderer: every
    frame, image and ray count bit-equal to the eager Renderer's; one
    capture per key (render_step, present_step, and present_step without
    the resample past frame 16); the entries of the old size dropped."""
    eager, graph = _pair()
    _same_frames(eager, graph, 18)
    steps = graph.steps
    assert len(steps.captures) == 3
    assert sorted(e.graph.replays for e in steps.entries.values()) \
        == [2, 16, 18]
    last, rays = graph.last_rays, float(graph.last_rays)
    for r in (eager, graph):
        r.build_pipeline(3, 1)  # the same key: frame 1 again
        r.update_scene(0.0)
        r.render_frame()
    assert float(last) == rays  # a later frame leaves it as it was
    for r in (eager, graph):
        r.build_pipeline(2, 1)
    _same_frames(eager, graph, 3)
    assert len(steps.captures) == 4 and len(steps.entries) == 4
    for r in (eager, graph):
        r.update_screen_size(12, 8)
    _same_frames(eager, graph, 3)
    assert len(steps.captures) == 6 and len(steps.entries) == 2
    save_checkpoint(str(tmp_path / "ck"), graph)
    resumed = Renderer("cornell", config=RenderConfig(
        width=12, height=8, max_depth=2), device="cpu")
    resumed.steps = CapturedSteps("cpu")
    resumed.render_frame()  # its own frame 1, then the checkpoint's state
    resumed.present()
    assert load_checkpoint(str(tmp_path / "ck"), resumed)
    _same_frames(eager, resumed, 3)


def test_captured_renderer_equal_shape_reuploads(captured):
    """The skinned strip, ticked and reuploaded before every frame: the
    tables keep their shapes, so nothing is captured again, the new tables
    are copied into the graph's, and every frame equals the eager one."""
    glb = skinned_strip_glb()
    eager, graph = _pair("viewer", glb)
    for k in range(5):
        for r in (eager, graph):
            r.update_scene(0.1 * k, reset=False)
        _same_frames(eager, graph, 1)
    assert len(graph.steps.captures) == 2
    assert graph.tables.features is next(
        iter(graph.steps.entries.values())).args[0][0].features


def test_captured_renderer_seeded_and_textured(captured):
    """The textured quad, G-buffer seeded, through the cache."""
    eager, graph = _pair("viewer", torch_scenes.textured_quad_glb())
    _same_frames(eager, graph, 3, use_gbuffer=True)
    _same_frames(eager, graph, 2)
    assert len(graph.steps.captures) == 3


def test_captured_bvh_step_rebuilds_packs(captured):
    """render_step(backend="bvh") through the cache: a scene of other
    values and equal shapes is copied into the graph's scene, and its
    packs are rebuilt into the graph's packs."""
    world = NativeWorld("cornell")
    world.update_camera(16, 12)
    scene = build_device_scene(world, device="cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    static = dict(width=16, height=12, spp=1, max_depth=3, backend="bvh",
                  use_gbuffer=False, narrow="jobs")
    steps = CapturedSteps("cpu")
    accum = torch.zeros((16 * 12, 4))
    jit = torch.zeros(2)
    (acc, _), args = steps.run(render_step, (scene, cam, torch.tensor(1),
                                             jit, accum), static,
                               donate=(4,))
    assert acc is accum and args[0] is scene
    moved = scene._replace(pos=scene.pos + torch.tensor([0.0, 0.05, 0.0]),
                           inst_tf=scene.inst_tf.clone())
    want = render_step(moved, cam, torch.tensor(2), jit, acc.clone(),
                       **static)[0]
    (got, _), args = steps.run(render_step, (moved, cam, torch.tensor(2),
                                             jit, acc), static, donate=(4,))
    assert len(steps.captures) == 1 and args[0] is scene
    assert torch.equal(scene.pos, moved.pos)
    assert torch.equal(_bits(got), _bits(want))
    entry = next(iter(steps.entries.values()))
    fresh = scene_packs(moved)
    for mine, new in zip(entry.packs[0], fresh):
        for m, n in zip(prr._tensors(mine), prr._tensors(new)):
            assert torch.equal(m, n)


def test_capture_drops_counts_of_the_capture(captured, monkeypatch):
    """kernels.launches counts a graph's launches at each replay, not
    those of its capture (the warm-up and the recording)."""
    counts = {k: 0 for k in prr.kernels.launches}
    monkeypatch.setattr(prr.kernels, "launches", counts)

    def step(x, *, width, height):
        counts["shade_rows"] += 2
        return (x * 2.0,)

    steps = CapturedSteps("cpu")
    x = torch.ones(4)
    for n in range(1, 4):
        (y,), _ = steps.run(step, (x,), dict(width=2, height=2))
        assert counts["shade_rows"] == 2 * n and torch.equal(y, x * 2.0)
    assert len(steps.captures) == 1
