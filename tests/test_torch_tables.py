"""The port's world-triangle tables against the JAX package's builder.

`world_tables_np` re-states the numpy flatten of `build_world_tris`
without JAX; it must give the same tables bit for bit, and
`tables_from_jax` must carry the JAX tables across unchanged.
"""

import numpy as np
import pytest

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.render.worldtris import (SHADE_COLS,
                                                   build_world_tris)
from webgpu_raytracer_tpu_torch.render import worldtris as port_wt

from tests.glb_fixture import character_glb, textured_quad_glb

SCENES = {
    "cornell": ("cornell", None),
    "mixed": ("mixed", None),
    "textured_quad": ("viewer", textured_quad_glb),
    "character": ("viewer", character_glb),
    "spheres": ("spheres", None),
}
KEYS = ("features", "shade_table", "light_rows", "light_count",
        "valid_count")


def _world(case):
    name, glb = SCENES[case]
    world = NativeWorld(name, glb_data=glb() if glb else None)
    world.update_camera(32, 32)
    return world


@pytest.mark.parametrize("case", ["cornell", "mixed", "textured_quad"])
def test_tables_bit_equal_to_jax_builder(case):
    world = _world(case)
    ref = build_world_tris(world)
    got = port_wt.world_tables_np(world)
    for key in KEYS:
        want = np.asarray(getattr(ref, key))
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)


@pytest.mark.parametrize("case", ["cornell", "mixed"])
def test_tables_from_jax_round_trip(case):
    world = _world(case)
    ref = build_world_tris(world)
    np_dict = {k: np.asarray(v) for k, v in ref._asdict().items()}
    carried = port_wt.tables_from_jax(np_dict)
    built = port_wt.build_world_tables(world, "cpu")
    for key in ("features", "shade_table", "light_rows"):
        np.testing.assert_array_equal(getattr(carried, key).numpy(),
                                      np_dict[key], err_msg=key)
        np.testing.assert_array_equal(getattr(built, key).numpy(),
                                      np_dict[key], err_msg=key)
    assert carried.light_count == built.light_count == int(ref.light_count)
    assert carried.valid_count == built.valid_count == int(ref.valid_count)


@pytest.mark.parametrize("case", ["cornell", "mixed", "character",
                                  "spheres"])
def test_tile_spheres_bit_equal_to_jax(case):
    """The cull's tile spheres: the port's rule against JAX
    `build_world_tris(...).spheres[:, 0, :4]`, also as carried across."""
    world = _world(case)
    ref = build_world_tris(world)
    want = np.asarray(ref.spheres)[:, 0, :4]
    got = port_wt.world_tables_np(world)["spheres"]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    carried = port_wt.tables_from_jax(
        {k: np.asarray(v) for k, v in ref._asdict().items()})
    np.testing.assert_array_equal(carried.spheres.numpy(), want)
    n_tiles = want.shape[0]
    assert (n_tiles > 1) == (case != "cornell")
    assert (want[:, 3] >= 0).all()  # no all-padding tile in these scenes


def test_shade_cols_match():
    assert port_wt.SHADE_COLS == SHADE_COLS
    assert port_wt.tri_pad(36) == 40 and port_wt.tri_pad(129) == 256
