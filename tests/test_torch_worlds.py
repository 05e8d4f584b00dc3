"""Worlds the port's other tests never load, against the JAX package: an
OBJ, and a skinned GLB ticked to t = 0.5; and the `Renderer` surface that
carries them.

- tables: the port's `build_world_tables` (through the port's own
  `NativeWorld`) bit-equal to JAX `build_world_tris` for the gem OBJ of
  bench.py's config 1 and for the skinned strip GLB at t = 0.5, as
  tests/test_torch_tables.py holds the presets; the tick moves the tables.
- goldens: the two GLB cases of tests/test_golden.py through the port's
  `trace_pixels_dense`, with that file's own bounds: `textured_glb`
  0.5185 +- 0.05 and `skinned_glb_t05` 0.5369 +- 0.05.
- `Renderer`: its positional arguments are the JAX package's (scene, OBJ
  text, GLB bytes, config); `update_scene(0.5)` on the skinned GLB changes
  the tables and the frame; `capture_frame()` returns the last presented
  image without presenting again.
"""

import numpy as np
import pytest
import torch

from webgpu_raytracer_tpu.models.native import NativeWorld as JaxWorld
from webgpu_raytracer_tpu.render.worldtris import build_world_tris
from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
from webgpu_raytracer_tpu_torch.render.worldtris import (build_world_tables,
                                                         world_tables_np)
from webgpu_raytracer_tpu_torch.utils.textures import (build_quad_pyramid,
                                                       decode_world_textures)

from bench import GEM_OBJ
from tests.glb_fixture import skinned_strip_glb, textured_quad_glb
from tests.test_golden import GOLDEN

# name -> (NativeWorld arguments, animation time or None)
WORLDS = {
    "gem_obj": (dict(obj_source=GEM_OBJ), None),
    "skinned_t05": (dict(glb_data=skinned_strip_glb()), 0.5),
}
KEYS = ("features", "shade_table", "light_rows", "light_count",
        "valid_count")


def _world(cls, case, res=32):
    kwargs, t = WORLDS[case]
    world = cls("viewer", **kwargs)
    if t is not None:
        world.update(t)
    world.update_camera(res, res)
    return world


@pytest.mark.parametrize("case", sorted(WORLDS))
def test_world_tables_bit_equal_to_jax(case):
    ref = build_world_tris(_world(JaxWorld, case))
    world = _world(NativeWorld, case)
    got = world_tables_np(world)
    assert int(ref.valid_count) > 0
    for key in KEYS:
        want = np.asarray(getattr(ref, key))
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    np.testing.assert_array_equal(got["spheres"],
                                  np.asarray(ref.spheres)[:, 0, :4])
    built = build_world_tables(world, "cpu")
    np.testing.assert_array_equal(built.features.numpy(),
                                  np.asarray(ref.features))
    np.testing.assert_array_equal(
        np.asarray(world.camera(), np.float32),
        np.asarray(_world(JaxWorld, case).camera(), np.float32))


def test_skinned_tick_moves_the_tables():
    world = NativeWorld("viewer", glb_data=skinned_strip_glb())
    world.update_camera(32, 32)
    at0 = world_tables_np(world)
    world.update(0.5)
    at05 = world_tables_np(world)
    assert at0["valid_count"] == at05["valid_count"] > 0
    assert not np.array_equal(at0["shade_table"], at05["shade_table"])
    assert not np.array_equal(at0["features"], at05["features"])


@pytest.mark.parametrize("case", ["textured_glb", "skinned_glb_t05"])
def test_golden_mean_radiance_glb(case):
    scene_name, depth, frames, res, glb, anim_t, expected, tol = GOLDEN[case]
    world = NativeWorld(scene_name, glb_data=glb())
    if anim_t is not None:
        world.update(anim_t)
    world.update_camera(res, res)
    tables = build_world_tables(world, "cpu")
    decoded = decode_world_textures(world)
    assert (decoded is not None) == (case == "textured_glb")
    textures = None if decoded is None else device_pyramid(
        build_quad_pyramid(decoded), "cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    mean = np.mean([
        trace_pixels_dense(tables, cam, f, torch.zeros(2), res, res, 1,
                           depth, textures=textures).mean().item()
        for f in range(1, frames + 1)])
    assert abs(mean - expected) < tol, (case, mean, expected, tol)


def test_renderer_takes_obj_text_second():
    """`Renderer(scene, obj_source, glb_data, config)`: OBJ text passed
    second positionally loads the gem (20 triangles), and the config
    fourth."""
    cfg = RenderConfig(width=16, height=16, max_depth=3)
    r = Renderer("viewer", GEM_OBJ, None, cfg, device="cpu")
    bare = Renderer("viewer", config=RenderConfig(width=16, height=16,
                                                  max_depth=3), device="cpu")
    assert r.config is cfg and (r.width, r.max_depth) == (16, 3)
    want = world_tables_np(_world(NativeWorld, "gem_obj", 16))
    assert r.tables.valid_count == int(want["valid_count"])
    assert r.tables.valid_count != bare.tables.valid_count
    np.testing.assert_array_equal(r.tables.features.numpy(),
                                  want["features"])
    r.render_frame()
    assert np.isfinite(r.radiance()).all() and r.radiance().mean() > 0.01


def test_renderer_takes_glb_bytes_third():
    r = Renderer("viewer", None, textured_quad_glb(),
                 RenderConfig(width=16, height=16, max_depth=3), device="cpu")
    assert r.textures is not None and r.tables.tex_slots[0]
    r.render_frame()
    assert np.isfinite(r.radiance()).all()


def test_renderer_update_scene_ticks_the_skinned_glb():
    def renderer():
        return Renderer("viewer", glb_data=skinned_strip_glb(),
                        config=RenderConfig(width=16, height=16,
                                            max_depth=3), device="cpu")

    r, still = renderer(), renderer()
    before = r.tables.shade_table.clone()
    r.render_frame()
    r.update_scene(0.5)
    assert r.frame_count == 0  # the tick resets the accumulation
    assert not torch.equal(r.tables.shade_table, before)
    want = world_tables_np(_world(NativeWorld, "skinned_t05", 16))
    np.testing.assert_array_equal(r.tables.shade_table.numpy(),
                                  want["shade_table"])
    r.render_frame()
    still.render_frame()
    assert np.isfinite(r.radiance()).all()
    assert not np.array_equal(r.radiance(), still.radiance())


def test_capture_frame_is_the_last_presented_image():
    r = Renderer("cornell", config=RenderConfig(width=16, height=12,
                                                max_depth=3), device="cpu")
    r.render_frame()
    first = r.capture_frame()  # nothing presented yet: presents
    assert first.shape == (12, 16, 3) and first.dtype == np.uint8
    history = r.history.clone()
    assert r.capture_frame() is first
    assert torch.equal(r.history, history)  # no second present
    r.render_frame()
    img = r.present()
    assert r.capture_frame() is img and not np.array_equal(img, first)
