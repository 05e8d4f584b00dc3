"""The port's hit reconstruction, light sampling and G-buffer against the
JAX package, and the port's own seeded-equals-traced property.

- `shade_from_rowT`, `seed_hit_from_wt_idx`, `sample_light_dense` and
  `light_pdf_from_rowT` are bit-equal to JAX on the same rows, rays and
  draws (cornell, the textured quad, the character GLB, and the textured
  quad with every texture slot bound).
- `render_gbuffer` at 32^2: tri_idx, inst_idx and wt_idx are equal, and
  albedo, normal_oct and depth bit-equal, wherever the two sweeps pick the
  same winner; where they differ the winners are f64 near-ties (the JAX
  CPU sweep ranks hits with an f32 matmul, the port with separately
  rounded f32 dot products).
- twins of tests/test_gbuffer_post.py: the octahedral round trip; the
  seeded bounce-0 hit bit-identical to the traced one; seeded frames equal
  to traced frames. The port runs eagerly, one program for both, so its
  frames are bit-equal, not only 99%.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops import dense_trace as jdt
from webgpu_raytracer_tpu.ops.gbuffer import render_gbuffer as jax_gbuffer
from webgpu_raytracer_tpu.ops.v3 import V3 as JV3
from webgpu_raytracer_tpu.utils.textures import (build_quad_pyramid,
                                                 decode_world_textures,
                                                 device_pyramid)
from webgpu_raytracer_tpu_torch.ops import dense_trace as pdt
from webgpu_raytracer_tpu_torch.ops.gbuffer import (pack_normal_oct,
                                                    render_gbuffer,
                                                    unpack_normal_oct)
from webgpu_raytracer_tpu_torch.ops.v3 import V3
from webgpu_raytracer_tpu_torch.render.worldtris import (SHADE_COLS,
                                                         tables_from_jax,
                                                         textures_from_jax)

from tests.glb_fixture import character_glb, textured_quad_glb
from tests.torch_common import (assert_near_ties, camera_rays,
                                jax_and_port_tables)

RES = 32
SCENES = {"cornell": ("cornell", None), "textured": ("viewer",
                                                     textured_quad_glb),
          "character": ("viewer", character_glb),
          "all_slots": ("viewer", textured_quad_glb)}


def _bind_all_slots(np_dict):
    """Bind the metal-rough, normal and emissive slots to the base colour
    texture wherever a row has one, so every sampler path runs."""
    out = dict(np_dict)
    lo = SHADE_COLS["tex"][0]
    for key in ("shade_table", "light_rows"):
        t = np.array(np_dict[key])
        base = t[:, lo]
        for k in (1, 2, 3):
            t[:, lo + k] = np.where(base >= 0, base, t[:, lo + k])
        out[key] = t
    return out


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(name, world, JAX wt, port tables, JAX textures, port textures)."""
    name, glb = SCENES[request.param]
    world, wt, tables = jax_and_port_tables(name, RES,
                                            glb() if glb else None)
    if request.param == "all_slots":
        np_dict = _bind_all_slots({k: np.asarray(v)
                                   for k, v in wt._asdict().items()})
        wt = wt._replace(shade_table=jnp.asarray(np_dict["shade_table"]),
                         light_rows=jnp.asarray(np_dict["light_rows"]))
        tables = tables_from_jax(np_dict)
        assert tables.tex_slots == (True, True, True, True)
    decoded = decode_world_textures(world)
    if decoded is None:
        jtex = jnp.ones((1, 1, 1, 3), jnp.float32)
        ptex = None
    else:
        pyr = build_quad_pyramid(decoded)
        jtex = device_pyramid(pyr)
        jtex = jtex[0] if jtex[1] is jtex[0] else jtex
        ptex = textures_from_jax(pyr)
    return request.param, world, wt, tables, jtex, ptex


def _rays(world):
    ro, rd = camera_rays(world, RES)
    jv = (JV3(*(jnp.asarray(ro[:, k]) for k in range(3))),
          JV3(*(jnp.asarray(rd[:, k]) for k in range(3))))
    pv = (V3(*(torch.from_numpy(np.ascontiguousarray(ro[:, k]))
               for k in range(3))),
          V3(*(torch.from_numpy(np.ascontiguousarray(rd[:, k]))
               for k in range(3))))
    return ro, rd, jv, pv


def _rows_idx(tables, seed=0):
    rs = np.random.default_rng(seed)
    idx = rs.integers(-1, tables.valid_count, RES * RES).astype(np.int32)
    return idx


def _eq(a, b, what):
    """Bit equality of a JAX result and a port result (V3s compared by
    component)."""
    if isinstance(b, V3):
        for ax, ca, cb in zip("xyz", a, b):
            np.testing.assert_array_equal(cb.numpy(), np.asarray(ca),
                                          err_msg=f"{what}.{ax}")
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=what)


@pytest.mark.parametrize("level", [0, 1])
def test_shade_from_rowT_bit_equal(scene, level):
    _, world, wt, tables, jtex, ptex = scene
    _, _, (jro, jrd), (pro, prd) = _rays(world)
    idx = _rows_idx(tables)
    st = np.asarray(wt.shade_table)
    rowT = np.where(idx[None] >= 0, st[np.clip(idx, 0, None)].T, 0.0)
    rowT = rowT.astype(np.float32)
    valid = idx >= 0
    want = jdt.shade_from_rowT(jtex, jnp.asarray(rowT), jro, jrd,
                               valid=jnp.asarray(valid), level=level)
    for slots in (pdt.ALL_SLOTS, tables.tex_slots):
        got = pdt.shade_from_rowT(ptex, torch.from_numpy(rowT), pro, prd,
                                  valid=torch.from_numpy(valid), level=level,
                                  slots=slots)
        for name, a, b in zip(("tex_u", "tex_v", "normal", "geom_n",
                               "albedo"), want, got):
            _eq(a, b, name)


def test_seed_hit_bit_equal(scene):
    _, world, wt, tables, jtex, ptex = scene
    _, _, (jro, jrd), (pro, prd) = _rays(world)
    idx = _rows_idx(tables, 1)
    want = jdt.seed_hit_from_wt_idx(wt, jtex, jnp.asarray(idx), jro, jrd)
    got = pdt.seed_hit_from_wt_idx(tables, ptex, torch.from_numpy(idx), pro,
                                   prd)
    for name in want._fields:
        _eq(getattr(want, name), getattr(got, name), name)


def test_sample_light_and_pdf_bit_equal(scene):
    _, world, wt, tables, jtex, ptex = scene
    rs = np.random.default_rng(2)
    n = RES * RES
    p = rs.uniform(-1, 1, (3, n)).astype(np.float32)
    r = rs.random((3, n)).astype(np.float32)
    want = jdt.sample_light_dense(wt, jtex, JV3(*map(jnp.asarray, p)),
                                  *map(jnp.asarray, r))
    got = pdt.sample_light_dense(tables, ptex, V3(*map(torch.from_numpy, p)),
                                 *map(torch.from_numpy, r))
    for name, a, b in zip(("L", "unit_l", "dist", "pdf"), want, got):
        _eq(a, b, name)
    idx = _rows_idx(tables, 3)
    rowT = np.asarray(wt.shade_table)[np.clip(idx, 0, None)].T.copy()
    t = rs.uniform(0.1, 5, n).astype(np.float32)
    _eq(jdt.light_pdf_from_rowT(wt, jnp.asarray(rowT), jnp.asarray(t),
                                JV3(*map(jnp.asarray, p))),
        pdt.light_pdf_from_rowT(tables, torch.from_numpy(rowT),
                                torch.from_numpy(t),
                                V3(*map(torch.from_numpy, p))), "light pdf")


def test_render_gbuffer_matches_jax(scene):
    name, world, wt, tables, jtex, ptex = scene
    ro, rd, _, _ = _rays(world)
    cam = np.asarray(world.camera(), np.float32)
    a = jax_gbuffer(wt, jtex, jnp.asarray(cam), RES, RES)
    b = render_gbuffer(tables, ptex, torch.from_numpy(cam), RES, RES)
    ia = np.asarray(a.wt_idx).reshape(-1)
    ib = b.wt_idx.numpy().reshape(-1)
    assert (ia >= 0).mean() > 0.2, name
    assert ((ia >= 0) == (ib >= 0)).all()
    differ = np.nonzero(ia != ib)[0]
    assert differ.size <= 0.01 * ia.size
    assert_near_ties(np.asarray(wt.shade_table), ro, rd, ia, ib, differ)
    same = (ia == ib).reshape(RES, RES)
    for field in ("tri_idx", "inst_idx", "depth"):
        fa = np.asarray(getattr(a, field))
        fb = getattr(b, field).numpy()
        assert fb.dtype == fa.dtype and fb.shape == fa.shape, field
        np.testing.assert_array_equal(fb[same], fa[same], err_msg=field)
    for field in ("albedo", "normal_oct"):
        fa = np.asarray(getattr(a, field))
        fb = getattr(b, field).numpy()
        np.testing.assert_array_equal(fb[same], fa[same], err_msg=field)


def test_octahedral_roundtrip():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v = V3(*(torch.from_numpy(np.ascontiguousarray(n[:, k]))
             for k in range(3)))
    out = unpack_normal_oct(*pack_normal_oct(v))
    back = torch.stack(list(out), dim=1).numpy()
    np.testing.assert_allclose(back, n, atol=2e-6)


def test_gbuffer_seed_hit_bit_identical(scene):
    """The seeded bounce-0 hit equals the traced hit field by field."""
    _, world, _, tables, _, ptex = scene
    _, _, _, (pro, prd) = _rays(world)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    gb = render_gbuffer(tables, ptex, cam, RES, RES)
    ha = pdt.intersect_and_shade(tables, ptex, pro, prd)
    hb = pdt.seed_hit_from_wt_idx(tables, ptex, gb.wt_idx.reshape(-1), pro,
                                  prd)
    for name in ha._fields:
        a, b = getattr(ha, name), getattr(hb, name)
        for x, y in (zip(a, b) if isinstance(a, V3) else [(a, b)]):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("frame", [1, 3])
def test_gbuffer_seeded_frame_matches_traced(scene, frame):
    """Whole frames at lens radius 0: seeded equals traced, bit for bit, on
    the row-state loop, untextured (cornell) and textured."""
    _, world, _, tables, _, ptex = scene
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    assert float(cam[3]) == 0.0
    gb = render_gbuffer(tables, ptex, cam, RES, RES)
    seed = gb.wt_idx.reshape(-1)
    a, ra = pdt.trace_pixels_dense(tables, cam, frame, torch.zeros(2), RES,
                                   RES, 1, 4, with_stats=True, textures=ptex)
    b, rb = pdt.trace_pixels_dense(tables, cam, frame, torch.zeros(2), RES,
                                   RES, 1, 4, with_stats=True, textures=ptex,
                                   seed_wt_idx=seed)
    assert torch.equal(a, b)
    assert float(ra) == float(rb) + RES * RES  # seeded: no primary rays
