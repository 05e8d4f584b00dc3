"""The port's plain `shade_step` against the JAX package's `shade_step`.

Inputs are one real bounce: cornell / mixed camera rays at 32^2, swept and
advanced `depth` bounces by the port's own loop, then handed to both
functions. Tolerances: the rng is bit-equal; the f32 rows match at
rtol 1e-4 / atol 1e-5 on >= 99.5% of lanes (sin/cos/sqrt differ by ulps
between XLA and ATen); the flag rows are equal on >= 99.5% of lanes.

Metal lanes are held looser, at rtol 5e-2, with this reason: mixed's
metal spheres have roughness 0, clamped to 0.005, and the GGX sample there
is ill-conditioned. Its 1 + (a*a - 1) * r2 cancels as r2 -> 1, so XLA's
FMA contraction and one ulp of cos/sin move the sampled direction by
~1e-3 and the pdf, whose D(n.h) peaks like 1/roughness**4, by a few %.
Every other lane is held at the bounds above.

Textured bounces: the port's row-state loop (`ray_color_dense_rows`, whose
`shade_step` samples the texture pyramid) against its per-ray
`ray_color_dense` from the same rng, on the textured quad, the formats
scene (four layers, mip in use), the character GLB (multi-tile, textured
lights), the formats scene with a fifth layer (so level 1 is level 0) and
a quad light with a textured base colour: radiance and ray counts bit for
bit (both are the same operations in the same order on the CPU). And the
textured `shade_step` with an all-white pyramid equals the white-texel
`shade_step` bit for bit.
"""

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.shade_rows import LROWS_PAD
from webgpu_raytracer_tpu.ops.shade_rows import shade_step as jax_shade_step
from webgpu_raytracer_tpu_torch import NativeWorld
from webgpu_raytracer_tpu_torch.ops import cuda_dense
from webgpu_raytracer_tpu_torch.ops import dense_trace as pdt
from webgpu_raytracer_tpu_torch.ops.dense import T_MAX, ray_stack
from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
from webgpu_raytracer_tpu_torch.ops.rng import init_rng
from webgpu_raytracer_tpu_torch.ops.shade_rows import (FLAG_ROWS, NS_OUT,
                                                       next_rays, shade,
                                                       shade_step)
from webgpu_raytracer_tpu_torch.ops.v3 import V3
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables
from webgpu_raytracer_tpu_torch.utils.textures import (build_quad_pyramid,
                                                       decode_world_textures)

from tests import torch_scenes
from tests.glb_fixture import character_glb, textured_quad_glb
from tests.torch_common import camera_rays, jax_and_port_tables

MAX_DEPTH = 5

_jax_shade = jax.jit(jax_shade_step, static_argnames=("max_depth",))


def bounce_inputs(scene, depth, res=32):
    """(tables, state, rng, rowT, idx) entering bounce `depth`."""
    world, _, tables = jax_and_port_tables(scene, res)
    ro_np, rd_np = camera_rays(world, res)
    R = res * res
    ro = V3(*(torch.from_numpy(np.ascontiguousarray(ro_np[:, k]))
              for k in range(3)))
    rd = V3(*(torch.from_numpy(np.ascontiguousarray(rd_np[:, k]))
              for k in range(3)))
    rng = init_rng(torch.arange(R, dtype=torch.int64), 1)
    _, idx, rowT = cuda_dense.closest_with_row(tables, ray_stack(ro, rd,
                                                                 T_MAX))
    one, zero = torch.ones(R), torch.zeros(R)
    state = torch.stack([one, *ro, *rd, one, one, one, zero, zero, zero,
                         zero, one, zero, zero, zero, zero, one])
    for d in range(depth):
        out, rng, rays8 = shade(state, rng, rowT, idx, tables.light_rows, d,
                                tables.light_count, MAX_DEPTH)
        _, idx2, rowT = cuda_dense.closest_with_row(tables, rays8, R)
        state = torch.cat([out[:19], (idx2[:R] >= 0).float()[None]])
        idx = idx2[R:]
    return tables, state, rng, rowT, idx


@pytest.mark.parametrize("scene,depth", [
    ("cornell", 0), ("cornell", 1), ("cornell", 4), ("mixed", 0),
    ("mixed", 2)])
def test_shade_step_matches_jax(scene, depth):
    tables, state, rng, rowT, idx = bounce_inputs(scene, depth)
    lr = tables.light_rows.numpy()
    lrowsT = np.zeros((40, LROWS_PAD), np.float32)
    lrowsT[:, :lr.shape[0]] = lr.T
    ref, ref_rng = _jax_shade(
        jnp.asarray(state.numpy()), jnp.asarray(rng.numpy().astype(np.uint32)),
        jnp.asarray(rowT.numpy()), jnp.asarray(idx.numpy().astype(np.float32)),
        jnp.asarray(lrowsT), jnp.int32(depth), jnp.int32(tables.light_count),
        max_depth=MAX_DEPTH)
    out, out_rng = shade_step(state, rng, rowT, idx, tables.light_rows,
                              depth, tables.light_count, MAX_DEPTH)
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == ref.shape == (NS_OUT, state.shape[1])
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out_rng.numpy(),
                                  np.asarray(ref_rng).astype(np.int64))

    f32_rows = [r for r in range(NS_OUT) if r not in FLAG_ROWS]
    metal = rowT.numpy()[27] == 1.0
    rtol = np.where(metal, 5e-2, 1e-4)
    close = (np.abs(out - ref) <= 1e-5 + rtol * np.abs(ref))[f32_rows].all(0)
    assert close.mean() >= 0.995, f"{close.mean():.2%} lanes close"
    flags = (out[list(FLAG_ROWS)] == ref[list(FLAG_ROWS)]).all(0)
    assert flags.mean() >= 0.995, f"{flags.mean():.2%} lanes equal"
    if depth == 0:  # something to compare: live lanes and NEE rays
        assert out[0].sum() > 0 and out[15].sum() > 0


def test_next_rays_layout():
    tables, state, rng, rowT, idx = bounce_inputs("cornell", 0, res=8)
    out, _, rays8 = shade(state, rng, rowT, idx, tables.light_rows, 0,
                          tables.light_count, MAX_DEPTH)
    R = out.shape[1]
    np.testing.assert_array_equal(rays8.numpy(), next_rays(out).numpy())
    np.testing.assert_array_equal(rays8[0:3, :R].numpy(), out[22:25].numpy())
    np.testing.assert_array_equal(rays8[3:6, R:].numpy(), out[1:4].numpy())
    np.testing.assert_array_equal(rays8[6, R:].numpy() > 0,
                                  out[26].numpy() > 0.5)


# name -> (GLB, res, depth, extra layer): the textured scenes.
TEXTURED = {"textured": (textured_quad_glb, 32, 4, False),
            "formats": (torch_scenes.formats_scene_glb, 32, 4, False),
            "character": (character_glb, 16, 3, False),
            "five_layers": (torch_scenes.formats_scene_glb, 32, 4, True),
            "textured_light": (torch_scenes.textured_light_glb, 32, 4, False)}


def textured_scene(name, white=False):
    """(tables, camera, pyramid, res, depth) on the CPU. five_layers adds
    a fifth layer, so that 5 * 128^2 > KRON_MAX_ROWS and level 1 is level
    0; white=True gives every layer white texels instead."""
    glb, res, depth, fifth = TEXTURED[name]
    world = NativeWorld("viewer", glb_data=glb())
    world.update_camera(res, res)
    tables = build_world_tables(world, "cpu")
    dec = decode_world_textures(world)
    if fifth:
        dec = np.concatenate([dec, dec[:1, ..., ::-1]])
    if white:
        dec = np.ones_like(dec)
    pyr = device_pyramid(build_quad_pyramid(dec), "cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    return tables, cam, pyr, res, depth


@pytest.mark.parametrize("name", sorted(TEXTURED))
def test_rows_loop_matches_ray_color_dense_textured(name):
    tables, cam, pyr, res, depth = textured_scene(name)
    assert (pyr[1] is pyr[0]) == (name == "five_layers")
    if name == "textured_light":
        assert tables.light_tex
    ro, rd = pdt.pinhole_rays(cam, res, res)
    for frame in (1, 2):
        rng = init_rng(torch.arange(res * res), frame)
        a, rng_a, rays_a = pdt.ray_color_dense(tables, pyr, ro, rd, rng,
                                               depth)
        b, rng_b, rays_b = pdt.ray_color_dense_rows(tables, ro, rd, rng,
                                                    depth, textures=pyr)
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"{name} frame {frame}"
        assert torch.equal(rng_a, rng_b)
        assert float(rays_a) == float(rays_b) > res * res
        assert float(a.x.mean()) > 0.01


@pytest.mark.parametrize("depth", [0, 2])
def test_shade_step_white_texture_is_untextured(depth):
    """The formats scene binds all four slots; with every texel white the
    textured shade_step is the white-texel one, bit for bit."""
    tables, cam, pyr, res, _ = textured_scene("formats", white=True)
    assert tables.tex_slots == (True, True, True, True)
    state, rng, rowT, idx = pdt.bounce_inputs(tables, cam, res, res, depth,
                                              MAX_DEPTH)
    args = (state, rng, rowT, idx, tables.light_rows, depth,
            tables.light_count, MAX_DEPTH)
    out_w, rng_w = shade_step(*args)
    out_t, rng_t = shade_step(*args, pyr)
    assert torch.equal(rng_w, rng_t)
    np.testing.assert_array_equal(out_t.numpy(), out_w.numpy())
    assert out_w[0].sum() > 0


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest the rational x, ties to even."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


def test_fma_rounding_finds_double_rounding():
    """torch_scenes.fma_rounding's exact fma equals the rational result
    rounded once, on random lerp inputs; on a constructed double-rounding
    tie the sampler's f64 emulation (`_fma_v3`) is one ulp off and
    fma_rounding says so."""
    from webgpu_raytracer_tpu_torch.ops.fetch import _fma_v3

    rs = np.random.default_rng(5)
    n = 2000
    a = (rs.integers(0, 256, n) / 255.0).astype(np.float32)
    b = rs.random(n, dtype=np.float32)
    c = (a * (1 - b)).astype(np.float32)
    a[:4] = np.float32(1 + 2.0 ** -23)          # the tie, and its mirror
    b[:4] = np.float32(2.0 ** -24 * (1 - 2.0 ** -23))
    c[:4] = np.float32(1 + 2.0 ** -23)
    a[2:4] *= -1
    c[2:4] *= -1
    emu, exact = torch_scenes.fma_rounding(*map(torch.from_numpy, (a, b, c)))
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(exact.numpy(), np.array(want, np.float32))
    same = _fma_v3(V3(*(torch.from_numpy(a),) * 3), torch.from_numpy(b),
                   V3(*(torch.from_numpy(c),) * 3)).x
    assert torch.equal(same, emu)
    assert exact[0] == np.float32(1 + 2.0 ** -23)
    assert emu[0] == np.float32(1 + 2.0 ** -22)
    assert (emu != exact).sum() == 4
