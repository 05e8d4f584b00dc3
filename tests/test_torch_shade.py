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
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.shade_rows import LROWS_PAD
from webgpu_raytracer_tpu.ops.shade_rows import shade_step as jax_shade_step
from webgpu_raytracer_tpu_torch.ops import cuda_dense
from webgpu_raytracer_tpu_torch.ops.dense import T_MAX, ray_stack
from webgpu_raytracer_tpu_torch.ops.rng import init_rng
from webgpu_raytracer_tpu_torch.ops.shade_rows import (FLAG_ROWS, NS_OUT,
                                                       next_rays, shade,
                                                       shade_step)
from webgpu_raytracer_tpu_torch.ops.v3 import V3

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
