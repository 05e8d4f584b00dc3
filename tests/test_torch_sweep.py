"""The port's plain sweep against the JAX package's sweeps.

Cornell (one tile) is held against the TPU kernel itself,
`pallas_dense._run(interpret=True)`; mixed (multi-tile) against the XLA
`dense_closest` / `dense_shadow`. The TPU kernel ranks hits in bf16x3
(~2**-16 relative), the port in f32, so:
- hit/miss sets are equal and t matches at rtol 2e-3 / atol 2e-4;
- winners that disagree must be f64 near-ties;
- rows of agreeing winners are bit-equal;
- occlusion is equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.dense import dense_closest, dense_shadow
from webgpu_raytracer_tpu.ops.pallas_dense import _run
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import cuda_dense

from tests.torch_common import (assert_near_ties, camera_rays,
                                jax_and_port_tables, random_rays, rays8_np)

R = 2048


def _ray_set(world, kind):
    """(ro, rd, active, tmax) numpy, R lanes."""
    if kind == "camera":
        ro, rd = camera_rays(world, 32)
        ro, rd = np.concatenate([ro, ro]), np.concatenate([rd, rd * 0.5])
        active = np.arange(R) % 7 != 0
        tmax = np.where(np.arange(R) % 4 == 0, 2.0, 1e30).astype(np.float32)
        return ro, rd, active, tmax
    return random_rays(R)


def _reference(scene, wt, ro, rd, active, tmax, row_from_lane):
    """JAX (t, idx, rows) and occlusion on the same rays."""
    if scene == "cornell":
        c = lambda a: tuple(jnp.asarray(a[:, k]) for k in range(3))
        t, idx, rows = _run(wt, c(ro), c(rd), jnp.asarray(tmax),
                            jnp.asarray(active), 1e-3, False, True,
                            row_from_lane=row_from_lane, interpret=True)
        occ = _run(wt, c(ro), c(rd), jnp.asarray(tmax), jnp.asarray(active),
                   1e-3, True, False, interpret=True)
        return (np.asarray(t), np.asarray(idx), np.asarray(rows),
                np.asarray(occ))
    t, idx = dense_closest(wt, jnp.asarray(ro), jnp.asarray(rd),
                           t_max=jnp.asarray(tmax),
                           active=jnp.asarray(active))
    occ = dense_shadow(wt, jnp.asarray(ro), jnp.asarray(rd),
                       t_max=jnp.asarray(tmax), active=jnp.asarray(active))
    idx = np.asarray(idx)
    st = np.asarray(wt.shade_table)
    rows = np.where(idx[row_from_lane:, None] >= 0,
                    st[np.clip(idx[row_from_lane:], 0, None)], 0.0).T
    return np.asarray(t), idx, rows, np.asarray(occ)


@pytest.mark.parametrize("scene,kind,row_from_lane", [
    ("cornell", "camera", 0), ("cornell", "random", 0),
    ("cornell", "random", R // 2), ("mixed", "camera", 0),
    ("mixed", "random", R // 2)])
def test_plain_sweep_matches_jax(scene, kind, row_from_lane):
    world, wt, tables = jax_and_port_tables(scene)
    ro, rd, active, tmax = _ray_set(world, kind)
    t_ref, i_ref, rows_ref, occ_ref = _reference(
        scene, wt, ro, rd, active, tmax, row_from_lane)

    rays8 = rays8_np(ro, rd, np.where(active, tmax, 0.0))
    before = dict(kernels.launches)
    t, idx, rows = cuda_dense.closest_with_row(tables, rays8, row_from_lane)
    occ = cuda_dense.shadow(tables, rays8)
    assert kernels.launches == before  # CPU tensors take the plain version
    t, idx, rows, occ = t.numpy(), idx.numpy(), rows.numpy(), occ.numpy()
    assert rows.shape == (40, R - row_from_lane)

    hit = i_ref >= 0
    np.testing.assert_array_equal(idx >= 0, hit)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(t[~hit], np.where(active, tmax, 0.0)[~hit])
    assert_near_ties(tables.shade_table.numpy(), ro, rd, i_ref, idx,
                     np.nonzero(hit & (idx != i_ref))[0])

    same = (idx == i_ref)[row_from_lane:]
    np.testing.assert_array_equal(rows[:, same], rows_ref[:, same])
    st = tables.shade_table.numpy()
    sel = np.nonzero(hit[row_from_lane:])[0]
    np.testing.assert_array_equal(rows[:, sel].T,
                                  st[idx[row_from_lane:][sel]])
    assert (rows[:, ~hit[row_from_lane:]] == 0).all()
    np.testing.assert_array_equal(occ, occ_ref)


def test_lowest_index_wins_exact_ties():
    """Two copies of one triangle: every hit reports the first copy."""
    world, _, tables = jax_and_port_tables("cornell")
    n = tables.valid_count
    tw = tables.features.shape[1] // 5
    f = tables.features.view(16, 5, tw).clone()
    f[:, :, n - 1] = f[:, :, 0]  # last valid tri := copy of tri 0
    dup = tables._replace(features=f.reshape(16, 5 * tw))
    ro, rd = camera_rays(world, 32)
    t, idx, _ = cuda_dense.closest_with_row(
        dup, rays8_np(ro, rd, np.full(len(ro), 1e30, np.float32)))
    assert (idx.numpy() != n - 1).all()


def test_wrapper_rejects_non_cpu_tensors_without_launching():
    _, _, tables = jax_and_port_tables("cornell")
    rays8 = torch.zeros((8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dense.closest_with_row(tables, rays8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dense.shadow(tables, rays8)
