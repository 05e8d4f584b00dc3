"""The job-stream narrow phase (the `_kernel3` port's plain versions), on the
CPU.

- Against the JAX package: the whole plain job path on CPU tensors
  (coherence sort, cull, `jobs_closest_plain` / `jobs_shadow_plain`, as
  `cuda_jobs.closest_with_row` / `shadow` chain them, at g = 128 and 256) against JAX
  `_run3(interpret=True, tune=TuneConfig(narrow="jobs", m_tile3=g))`, as
  tests/test_two_level.py runs it, on its grid and ladder fixtures. The
  TPU kernel ranks hits in bf16x3 (its CPU emulation is off by up to
  ~1.2e-3 relative, test_two_level.py's note), the port in f32, so: hit /
  miss sets equal, winners equal but for f64 near-ties, t within that
  test's rtol 2e-3 / atol 2e-4, the port's rows equal to shade_table[idx]
  bit for bit, occlusion equal. On the ladder the JAX test's claim is one
  winner cluster per lane; 15 of its 384 live lanes fall on an edge two
  triangles share, where the two rankings may pick either.
- Against the full sweep: the plain job path's t, idx and rows are
  bit-equal to `closest_plain` / `rows_plain` over every tile, and its
  occlusion equal to `shadow_plain`, on the grid, ladder, drain, mixed and
  spheres fixtures, with directions scaled to |d| ~ 10 (primary rays are
  not unit length) and some t_max bounded.
- Ties inside one tile (`torch_common.tie_case`: copies one and 32 indices
  up): the lowest index wins, occlusion is that of the full sweep, and the
  JAX `_run3` agrees but for the tied winners.
- Stats: `job_sweep(with_stats=True)` counts, per group, the tiles and the
  (lane, tile) pairs that the kernel's per-lane sphere test lets through
  (`jobs_stats_plain`), and leaves the outputs as they are.
- Dispatch: `cuda_dense` sends every multi-tile scene (and only those)
  through the job path.
- Fixtures: `dense_trace.bounce_rays` gives the fused stack that the
  row-state loop sweeps at that bounce.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.pallas_dense import _run3
from webgpu_raytracer_tpu.ops.tune import TuneConfig as JaxTune
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import cuda_dense, cuda_jobs, dense_trace
from webgpu_raytracer_tpu_torch.ops.coherence import coherence_sort
from webgpu_raytracer_tpu_torch.ops.cluster_cull import lane_terms, pair_ok
from webgpu_raytracer_tpu_torch.ops.dense import (closest_plain, rows_plain,
                                                  shadow_plain,
                                                  worklist_mask)
from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
from webgpu_raytracer_tpu_torch.ops.rng import init_rng
from webgpu_raytracer_tpu_torch.utils.textures import (build_quad_pyramid,
                                                       decode_world_textures)

from tests.glb_fixture import character_glb
from tests.test_two_level import (drain_world, grid_wt,  # noqa: F401
                                  ladder_world)
from tests.torch_common import (assert_near_ties, camera_rays,
                                jax_and_port_tables, job_cases, scaled_case,
                                stack8, tie_case, TIE_NEXT, TIE_STRIDE)


@pytest.fixture(scope="module")
def cases(grid_wt, ladder_world, drain_world):  # noqa: F811
    return job_cases(grid_wt, ladder_world, drain_world)


def _jax_run3(wt, ro, rd, t_max, g, any_hit):
    c = lambda a: tuple(jnp.asarray(a[k]) for k in range(3))  # noqa: E731
    return _run3(wt, c(ro), c(rd), jnp.asarray(t_max),
                 jnp.asarray(t_max > 0), 1e-3, any_hit, not any_hit,
                 interpret=True, tune=JaxTune(narrow="jobs", m_tile3=g))


def _job_path(tables, rays8, g, any_hit):
    """`cuda_jobs.closest_with_row` / `shadow` (one segment) at group size
    g."""
    rays_s, perm = coherence_sort(rays8, tables.spheres, g)
    order, counts = cuda_jobs.worklists(tables.spheres, rays_s, g)
    return cuda_jobs.job_sweep(tables, rays_s, perm, order, counts, g,
                               rays8.shape[1], any_hit)


@pytest.mark.parametrize("case,g", [("grid", 128), ("grid", 256),
                                    ("ladder", 128)])
def test_job_path_matches_jax_run3(cases, grid_wt, ladder_world,  # noqa: F811
                                   case, g):
    wt = grid_wt if case == "grid" else ladder_world[0]
    tables, ro, rd, t_max, _ = cases[case]
    t_j, i_j, _ = (np.asarray(a) for a in _jax_run3(wt, ro, rd, t_max, g,
                                                     False))
    occ_j = np.asarray(_jax_run3(wt, ro, rd, t_max, g, True))

    rays8 = stack8(ro, rd, t_max)
    t, idx, rows = (a.numpy() for a in _job_path(tables, rays8, g, False))
    occ = _job_path(tables, rays8, g, True).numpy()

    hit = i_j >= 0
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(idx >= 0, hit)
    differ = np.nonzero(hit & (idx != i_j))[0]
    assert_near_ties(tables.shade_table.numpy(), ro.T, rd.T, i_j, idx,
                     differ)
    np.testing.assert_allclose(t[hit], t_j[hit], rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(t[~hit], t_max[~hit])
    st = tables.shade_table.numpy()
    np.testing.assert_array_equal(rows[:, hit].T, st[idx[hit]])
    assert (rows[:, ~hit] == 0).all()
    np.testing.assert_array_equal(occ, occ_j)
    if case == "ladder":
        assert differ.size <= 15, differ.size  # shared-edge lanes only


@pytest.mark.parametrize("case", ["grid", "ladder", "drain", "mixed",
                                  "spheres"])
def test_job_path_bit_equal_to_full_sweep(cases, case):
    tables, ro, rd, t_max, split = scaled_case(cases[case])
    rays8 = stack8(ro, rd, t_max)
    before = dict(kernels.launches)
    t, idx, rows = cuda_dense.closest_with_row(tables, rays8, split)
    occ = cuda_dense.shadow(tables, rays8)
    assert kernels.launches == before  # CPU tensors: the plain versions
    t_f, idx_f = closest_plain(tables, rays8)
    assert (idx_f >= 0).any()
    assert torch.equal(idx, idx_f)
    assert torch.equal(t.view(torch.int32), t_f.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), rows_plain(
        tables.shade_table, idx_f[split:]).view(torch.int32))
    assert torch.equal(occ, shadow_plain(tables, rays8))


@pytest.mark.parametrize("g", [128, 256])
def test_exact_tie_inside_a_tile_goes_to_the_lowest_index(grid_wt,  # noqa: F811
                                                          g):
    """Copies of a triangle one and 32 indices up in its own tile tie with it
    exactly on every lane that hits it: through the job path the original
    wins, as in the full sweep; occlusion is unchanged; and the JAX `_run3`
    agrees on hits, t and occlusion, its winners differing only between a
    triangle and its copy or on other f64 near-ties."""
    wt, tables, copies, ro, rd, t_max = tie_case(grid_wt)
    rays8 = stack8(ro, rd, t_max)
    t_f, idx_f = closest_plain(tables, rays8)
    hit = (idx_f >= 0).numpy()
    won = idx_f.numpy()[hit]
    assert not copies[won].any()
    # The ties are real: lanes won by an original hit its copy at the same
    # t once the original is gone.
    tw = tables.features.shape[1] // 5
    originals = np.zeros(tw, bool)
    originals[TIE_NEXT + TIE_STRIDE] = True
    tied = np.zeros_like(hit)
    tied[hit] = originals[won]
    assert int(tied.sum()) > 300
    feats = tables.features.clone().view(-1, 5, tw)
    feats[:, :, torch.from_numpy(originals)] = 0.0
    t_c, idx_c = closest_plain(tables._replace(
        features=feats.view(-1, 5 * tw)), rays8)
    lanes = torch.from_numpy(tied)
    assert copies[idx_c[lanes].numpy()].all()
    assert torch.equal(t_c[lanes].view(torch.int32),
                       t_f[lanes].view(torch.int32))

    t, idx, rows = _job_path(tables, rays8, g, False)
    assert torch.equal(idx, idx_f)
    assert torch.equal(t.view(torch.int32), t_f.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), rows_plain(
        tables.shade_table, idx_f).view(torch.int32))
    occ = _job_path(tables, rays8, g, True)
    assert torch.equal(occ, shadow_plain(tables, rays8))

    t_j, i_j, _ = (np.asarray(a) for a in _jax_run3(wt, ro, rd, t_max, g,
                                                     False))
    np.testing.assert_array_equal(i_j >= 0, hit)
    differ = np.nonzero(hit & (idx.numpy() != i_j))[0]
    assert_near_ties(tables.shade_table.numpy(), ro.T, rd.T, i_j,
                     idx.numpy(), differ)
    np.testing.assert_allclose(t.numpy()[hit], t_j[hit], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(_jax_run3(wt, ro, rd, t_max, g, True)))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["grid", "ladder", "drain", "mixed"])
def test_job_stats_count_the_touching_lanes(cases, case, any_hit):
    """`with_stats` appends [tiles walked, pairs walked, worklist length]
    per group and changes no output. A lane's segment only shrinks, so the
    pairs walked lie between the pairs its final segment touches (each
    lane's own t_max in any-hit mode, for the lanes that end unoccluded)
    and the pairs its first one does."""
    tables, ro, rd, t_max, split = scaled_case(cases[case])
    rays8 = stack8(ro, rd, t_max)
    g = 128
    rays_s, perm = coherence_sort(rays8, tables.spheres, g)
    order, counts = cuda_jobs.worklists(tables.spheres, rays_s, g)
    args = (tables, rays_s, perm, order, counts, g, rays8.shape[1], any_hit)
    plain = cuda_jobs.job_sweep(*args)
    *out, stats = cuda_jobs.job_sweep(*args, with_stats=True)
    for a, b in zip(out, plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(a, b)
    assert stats.shape == (counts.shape[0], 3) and stats.dtype == torch.int32
    assert torch.equal(stats[:, 2], counts)
    assert (stats[:, 0] <= stats[:, 2]).all()
    assert (stats[:, 1] >= stats[:, 0]).all()
    assert (stats[:, 1] <= g * stats[:, 0]).all()

    ct = tables.spheres.shape[0]
    listed = worklist_mask(order, counts, ct).repeat_interleave(g, 0).T
    dd = lane_terms(rays_s, tables.spheres)[0]

    def pairs(t_end):
        ok = pair_ok(rays_s, dd, t_end, tables.spheres)
        return int((ok & listed).sum())

    first = pairs(rays_s[6].clamp(min=0.0))
    if any_hit:
        occ_s = torch.zeros(rays_s.shape[1], dtype=torch.bool)
        keep = perm < rays8.shape[1]
        occ_s[keep] = out[0][perm[keep].long()]
        last = pairs(torch.where(occ_s, 0.0, rays_s[6]))
    else:
        t_s = torch.zeros(rays_s.shape[1])
        keep = perm < rays8.shape[1]
        t_s[keep] = out[0][perm[keep].long()]
        last = pairs(t_s)
    assert last <= int(stats[:, 1].sum()) <= first
    assert int(stats[:, 1].sum()) > 0 and (any_hit or last > 0)


def _count_sweeps(monkeypatch):
    calls = {"jobs": 0, "full": 0}

    def wrap(fn, key):
        def counted(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return counted

    monkeypatch.setattr(cuda_jobs, "job_sweep",
                        wrap(cuda_jobs.job_sweep, "jobs"))
    monkeypatch.setattr(cuda_dense, "full_sweep",
                        wrap(cuda_dense.full_sweep, "full"))
    return calls


@pytest.mark.parametrize("scene", ["cornell", "viewer", "special", "mesh",
                                   "mixed", "character"])
def test_multi_tile_scenes_take_the_job_path(monkeypatch, scene):
    """One frame at 8^2 d2: 1 + 2 sweeps, all through the job path for a
    multi-tile scene and all through the full walk for cornell (one
    tile)."""
    glb = character_glb() if scene == "character" else None
    world, _, tables = jax_and_port_tables(
        "viewer" if scene == "character" else scene, 8, glb_data=glb)
    multi = tables.features.shape[1] // 5 > 128
    assert multi == (scene != "cornell")
    textures = None
    if glb is not None:
        textures = device_pyramid(build_quad_pyramid(
            decode_world_textures(world)), "cpu")
    calls = _count_sweeps(monkeypatch)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    col = dense_trace.trace_pixels_dense(tables, cam, 1, torch.zeros(2), 8,
                                         8, 1, 2, textures=textures)
    assert torch.isfinite(col).all()
    assert calls == ({"jobs": 3, "full": 0} if multi
                     else {"jobs": 0, "full": 3})


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("scene", ["cornell", "mixed"])
def test_bounce_rays_are_the_loops_sweeps(monkeypatch, scene, depth):
    """`bounce_rays(depth)` is the fused (8, 2R) stack that bounce `depth`
    of `ray_color_dense_rows` sweeps, from `pinhole_rays` (the pixel
    centers) and frame 1's rng streams, at 8^2 d3."""
    res, max_depth = 8, 3
    world, _, tables = jax_and_port_tables(scene, res)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    ro, rd = dense_trace.pinhole_rays(cam, res, res)
    ro_np, rd_np = camera_rays(world, res)
    np.testing.assert_array_equal(torch.stack([ro.x, ro.y, ro.z], 1), ro_np)
    np.testing.assert_array_equal(torch.stack([rd.x, rd.y, rd.z], 1), rd_np)

    swept = []
    closest = dense_trace.closest_with_row

    def spy(tables, rays8, row_from_lane=0, narrow="jobs"):
        swept.append(rays8.clone())
        return closest(tables, rays8, row_from_lane, narrow)

    monkeypatch.setattr(dense_trace, "closest_with_row", spy)
    dense_trace.ray_color_dense_rows(
        tables, ro, rd, init_rng(torch.arange(res * res), 1), max_depth)
    assert len(swept) == 1 + max_depth
    want = swept[1 + depth]
    got = dense_trace.bounce_rays(tables, cam, res, res, depth, max_depth)
    assert got.shape == (8, 2 * res * res)
    assert torch.equal(got, want)
