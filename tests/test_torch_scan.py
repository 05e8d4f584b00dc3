"""The scan narrow phase (the `_kernel2` port's plain versions) and its
keyed culls, on the CPU.

Fixtures: tests/test_two_level.py's grid (random rays), ladder (one winner
cluster per lane) and drain worlds, and the fused bounce-1 ray stacks of
mixed (35 tiles) and spheres (2,009 tiles) at 16^2.

- Keyed exact cull: `worklists_keyed_plain` against JAX
  `tile_cluster_worklist_exact(with_keys=True)` on the same sorted rays, at
  m = 512 and 1024. Survivor sets equal but for clusters whose test sits
  within 1e-5 relative of its threshold (`tests/test_torch_cull.py`'s
  tolerance: XLA's CPU backend may contract the dot products into FMAs);
  keys of common survivors within rtol 1e-5 (plus 1e-5 of the tile's
  largest key: a key is a difference -b - sq that cancels where a lane
  starts on a sphere's surface); keys ascending within each count.
- Cone cull: `cone_worklists_plain` against JAX
  `tile_cluster_worklist(sub=32)` likewise (its test is a margin of 1e-6
  in the cosine domain, so survivor sets may differ on at most 0.5% of the
  entries), and its survivors hold the exact cull's.
- Against the JAX kernel: the plain scan path on CPU tensors, as
  `cuda_scan.closest_with_row` / `shadow` chain it at m = 512, against
  `_run2(interpret=True, tune=TuneConfig(m_tile2=512))` on the grid, drain
  and ladder fixtures, at the tolerance of `tests/test_torch_jobs.py::
  test_job_path_matches_jax_run3`: the TPU kernel ranks hits in bf16x3
  (its CPU emulation is off by up to ~1.2e-3 relative), the port in f32,
  so hit / miss sets equal, winners equal but for f64 near-ties, t within
  rtol 2e-3 / atol 2e-4, the port's rows equal to shade_table[idx],
  occlusion equal.
- Against the port itself: t, idx, rows and occlusion bit-equal to the full
  sweep over every tile and to the job path, on all five fixtures with
  both culls.
- Stats: the ladder's one 512-lane tile processes 7 clusters, as
  tests/test_two_level.py asserts of the JAX kernel; entries scanned never
  exceed the worklist length, nor entries processed the scanned; a
  processed entry walks between one lane and all.
- Ties: a cluster duplicated under a higher index and scanned first gives
  every lane that hits it an exact-t tie across two tiles; the lowest
  index wins in the scan path, the job path and the full sweep.
- Ties inside one tile (`torch_common.tie_case`: copies one and 32 indices
  up): the lowest index wins with both culls, occlusion is that of the
  full sweep, and the JAX `_run2` agrees but for the tied winners.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.cluster_cull import (
    tile_cluster_worklist, tile_cluster_worklist_exact)
from webgpu_raytracer_tpu.ops.pallas_dense import (_run2,
                                                   rayf_from_components)
from webgpu_raytracer_tpu.ops.tune import TuneConfig as JaxTune
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import cuda_dense, cuda_jobs, cuda_scan
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (
    cone_worklists_plain, lane_terms, worklists_keyed_plain)
from webgpu_raytracer_tpu_torch.ops.coherence import coherence_sort
from webgpu_raytracer_tpu_torch.ops.dense import (closest_plain, rows_plain,
                                                  shadow_plain,
                                                  worklist_mask)

from tests.test_torch_cull import _near_threshold
from tests.test_two_level import (drain_world, grid_wt,  # noqa: F401
                                  ladder_world)
from tests.torch_common import (assert_near_ties, job_cases, scaled_case,
                                stack8, tie_case)

CASES = ("grid", "ladder", "drain", "mixed", "spheres")
CULLS = ("exact", "cone")


@pytest.fixture(scope="module")
def cases(grid_wt, ladder_world, drain_world):  # noqa: F811
    return job_cases(grid_wt, ladder_world, drain_world)


def _sorted_case(cases, case, m):
    tables, ro, rd, t_max, split = cases[case]
    seg = split if split % m == 0 else 0
    rays_s, _ = coherence_sort(stack8(ro, rd, t_max), tables.spheres, m, seg)
    return tables, rays_s


def _jax_worklists(fn, tables, rays_s, m, **kw):
    rs = [jnp.asarray(rays_s[k].numpy()) for k in range(7)]
    rayf = rayf_from_components(rs[3], rs[4], rs[5], rs[0], rs[1], rs[2])
    order, keys, counts = fn(rayf, rs[6], jnp.asarray(tables.spheres.numpy()),
                             m, **kw)
    return (torch.from_numpy(np.array(order)), torch.from_numpy(
        np.array(keys)), torch.from_numpy(np.array(counts)))


def _key_map(order, keys, counts):
    """(T, Ct) f32: a survivor's key at its cluster id, nan elsewhere."""
    pos = torch.arange(order.shape[1])[None, :] < counts[:, None]
    out = torch.full(order.shape, float("nan"))
    out.scatter_(1, order.long(), torch.where(pos, keys, float("nan")))
    return out


def _assert_contract(order, keys, counts, ct):
    """Survivors first, their keys ascending and below 3e38, each cluster
    once; 3e38 past the count."""
    pos = torch.arange(ct)[None, :] < counts[:, None]
    assert (torch.sort(order.long(), 1).values == torch.arange(ct)).all()
    assert (keys[pos] < 3e38).all() and (keys[pos] >= 0).all()
    assert (keys[~pos] >= 3e38).all()
    assert (keys[:, 1:] >= keys[:, :-1]).all()


def _assert_keys_close(mine, theirs):
    both = ~torch.isnan(mine) & ~torch.isnan(theirs)
    assert both.any()
    scale = torch.where(both, theirs, 0.0).amax(1, keepdim=True)
    err = (mine - theirs).abs()
    assert (err[both] <= (1e-5 * theirs.abs() + 1e-5 * scale)[both]).all(), \
        float((err / (theirs.abs() + scale))[both].max())


@pytest.mark.parametrize("m", [512, 1024])
@pytest.mark.parametrize("case", ["grid", "drain", "spheres"])
def test_keyed_cull_matches_jax(cases, case, m):
    tables, rays_s = _sorted_case(cases, case, m)
    ct = tables.spheres.shape[0]
    order, keys, counts = worklists_keyed_plain(tables.spheres, rays_s, m)
    assert order.shape == keys.shape == (rays_s.shape[1] // m, ct)
    _assert_contract(order, keys, counts, ct)
    order_j, keys_j, counts_j = _jax_worklists(
        tile_cluster_worklist_exact, tables, rays_s, m)
    mine = worklist_mask(order, counts, ct)
    theirs = worklist_mask(order_j, counts_j, ct)
    assert int(counts.sum()) > 0
    _, t_clip = lane_terms(rays_s, tables.spheres)
    for tile, cl in torch.nonzero(theirs != mine).tolist():
        lanes = np.arange(tile * m, (tile + 1) * m)
        assert _near_threshold(rays_s, t_clip, tables.spheres[cl], lanes), \
            f"{case}: cluster {cl} of tile {tile} differs"
    _assert_keys_close(_key_map(order, keys, counts),
                       _key_map(order_j, keys_j, counts_j))


@pytest.mark.parametrize("m", [512, 1024])
@pytest.mark.parametrize("case", ["grid", "drain", "spheres"])
def test_cone_cull_matches_jax_and_holds_the_exact_cull(cases, case, m):
    tables, rays_s = _sorted_case(cases, case, m)
    ct = tables.spheres.shape[0]
    order, keys, counts = cone_worklists_plain(tables.spheres, rays_s, m)
    _assert_contract(order, keys, counts, ct)
    order_j, keys_j, counts_j = _jax_worklists(
        tile_cluster_worklist, tables, rays_s, m, sub=32)
    mine = worklist_mask(order, counts, ct)
    theirs = worklist_mask(order_j, counts_j, ct)
    assert int((mine != theirs).sum()) <= 0.005 * int(theirs.sum())
    _assert_keys_close(_key_map(order, keys, counts),
                       _key_map(order_j, keys_j, counts_j))
    exact = worklist_mask(*worklists_keyed_plain(
        tables.spheres, rays_s, m)[::2], ct)
    assert not (exact & ~mine).any()
    assert int(mine.sum()) >= int(exact.sum()) > 0


def _jax_run2(wt, ro, rd, t_max, any_hit, **kw):
    c = lambda a: tuple(jnp.asarray(a[k]) for k in range(3))  # noqa: E731
    return _run2(wt, c(ro), c(rd), jnp.asarray(t_max),
                 jnp.asarray(t_max > 0), 1e-3, any_hit, not any_hit,
                 interpret=True, tune=JaxTune(m_tile2=512), **kw)


@pytest.mark.parametrize("case", ["grid", "drain", "ladder"])
def test_scan_path_matches_jax_run2(cases, grid_wt, drain_world,  # noqa: F811
                                    ladder_world, case):  # noqa: F811
    wt = {"grid": grid_wt, "drain": drain_world[0],
          "ladder": ladder_world[0]}[case]
    tables, ro, rd, t_max, _ = cases[case]
    t_j, i_j, _ = (np.asarray(a) for a in _jax_run2(wt, ro, rd, t_max,
                                                     False))
    occ_j = np.asarray(_jax_run2(wt, ro, rd, t_max, True))

    rays8 = stack8(ro, rd, t_max)
    t, idx, rows = (a.numpy() for a in cuda_scan.closest_with_row(
        tables, rays8, m=512))
    occ = cuda_scan.shadow(tables, rays8, m=512).numpy()

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


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("cull", CULLS)
@pytest.mark.parametrize("case", CASES)
def test_scan_path_bit_equal_to_full_sweep_and_job_path(cases, case, cull):
    tables, ro, rd, t_max, split = scaled_case(cases[case])
    rays8 = stack8(ro, rd, t_max)
    before = dict(kernels.launches)
    t, idx, rows, stats = cuda_scan.closest_with_row(
        tables, rays8, split, m=512, cull=cull, with_stats=True)
    occ, stats_any = cuda_scan.shadow(tables, rays8, m=512, cull=cull,
                                      with_stats=True)
    assert kernels.launches == before  # CPU tensors: the plain versions
    t_f, idx_f = closest_plain(tables, rays8)
    assert (idx_f >= 0).any()
    assert torch.equal(idx, idx_f)
    assert torch.equal(_bits(t), _bits(t_f))
    assert torch.equal(_bits(rows), _bits(rows_plain(tables.shade_table,
                                                     idx_f[split:])))
    assert torch.equal(occ, shadow_plain(tables, rays8))
    t_j, idx_j, rows_j = cuda_jobs.closest_with_row(tables, rays8, split)
    assert torch.equal(idx, idx_j) and torch.equal(_bits(t), _bits(t_j))
    assert torch.equal(_bits(rows), _bits(rows_j))
    assert torch.equal(occ, cuda_jobs.shadow(tables, rays8))
    for s in (stats, stats_any):
        assert s.shape == (-(-rays8.shape[1] // 512), 4)
        assert (s[:, 1] <= s[:, 0]).all() and (s[:, 0] <= s[:, 2]).all()
        # Every processed entry walks at least one lane, at most all.
        assert (s[:, 3] >= s[:, 1]).all() and (s[:, 3] <= 512 * s[:, 1]).all()
    assert int(stats[:, 1].sum()) > 0


def test_default_tile_and_cull_through_the_dispatch(cases):
    """`cuda_dense` sends `narrow="scan"` through this path at the default
    tile size (1,024 lanes) and the exact cull; an unknown narrow phase
    raises, for a single-tile scene too."""
    tables, ro, rd, t_max, split = scaled_case(cases["mixed"])
    rays8 = stack8(ro, rd, t_max)
    t, idx, rows = cuda_dense.closest_with_row(tables, rays8, split,
                                               narrow="scan")
    t_d, idx_d, rows_d = cuda_scan.closest_with_row(tables, rays8, split)
    assert torch.equal(idx, idx_d) and torch.equal(_bits(t), _bits(t_d))
    assert torch.equal(_bits(rows), _bits(rows_d))
    t_f, idx_f = closest_plain(tables, rays8)
    assert torch.equal(idx, idx_f) and torch.equal(_bits(t), _bits(t_f))
    assert torch.equal(cuda_dense.shadow(tables, rays8, narrow="scan"),
                       shadow_plain(tables, rays8))
    with pytest.raises(ValueError, match="narrow"):
        cuda_dense.closest_with_row(tables, rays8, narrow="bogus")
    with pytest.raises(ValueError, match="narrow"):
        cuda_dense.shadow(tables, rays8, narrow="bogus")
    with pytest.raises(ValueError, match="cull"):
        cuda_scan.shadow(tables, rays8, cull="bogus")


def test_ladder_stats_match_the_jax_kernels(cases, ladder_world):  # noqa: F811
    """One 512-lane tile whose 7 clusters all win lanes: 7 processed, as
    tests/test_two_level.py asserts of `_run2(with_stats=True)`; the JAX
    kernel's own count is read here too."""
    wt = ladder_world[0]
    tables, ro, rd, t_max, _ = cases["ladder"]
    stats_j = np.asarray(_jax_run2(wt, ro, rd, t_max, False,
                                   with_stats=True)[-1])
    *_, stats = cuda_scan.closest_with_row(tables, stack8(ro, rd, t_max),
                                           m=512, with_stats=True)
    assert stats.shape == (1, 4)
    assert stats[0, :3].tolist() == [7, 7, 7]
    assert 7 <= int(stats[0, 3]) <= 7 * 384  # pairs walked, 384 live lanes
    assert int(stats_j[0, 1]) == 7 and int(stats_j[0, 2]) == 7


@pytest.mark.parametrize("cull", CULLS)
def test_exact_tie_across_tiles_goes_to_the_lowest_index(cases, cull):
    """Tile 2's valid triangles become copies of tile 0's first ones, under
    a sphere 5% larger, and the worklists visit the copy first: every lane
    that hits such a triangle of tile 0 ties exactly with its copy 256
    indices up, and the lower index wins in the scan path as in the job
    path and the full sweep."""
    tables, ro, rd, t_max, split = cases["grid"]
    tw = tables.features.shape[1] // 5
    feats = tables.features.clone().view(-1, 5, tw)
    feats[:, :, 256:384] = feats[:, :, 0:128]
    shade = tables.shade_table.clone()
    shade[256:384] = shade[0:128]
    spheres = tables.spheres.clone()
    spheres[2] = spheres[0] * torch.tensor([1.0, 1.0, 1.0, 1.05])
    tied = tables._replace(features=feats.view(-1, 5 * tw),
                           shade_table=shade, spheres=spheres)
    rays8 = stack8(ro, rd, t_max)

    t_f, idx_f = closest_plain(tied, rays8)
    n_copy = tables.valid_count - 256
    assert 0 < n_copy < 128
    low = (idx_f >= 0) & (idx_f < n_copy)
    assert int(low.sum()) > 50 and not (idx_f // 128 == 2).any()
    # The tie is real: without tile 0, the same lanes hit the copy at the
    # same t.
    no0 = feats.clone()
    no0[:, :, 0:128] = 0.0
    t_c, idx_c = closest_plain(tied._replace(
        features=no0.view(-1, 5 * tw)), rays8)
    assert torch.equal(idx_c[low], idx_f[low] + 256)
    assert torch.equal(_bits(t_c[low]), _bits(t_f[low]))

    rays_s, perm = coherence_sort(rays8, tied.spheres, 512, 0)
    order, keys, counts = cuda_scan.worklists_keyed(tied.spheres, rays_s,
                                                    512, cull)
    # Where the two keys are equal (lanes inside both spheres: key 0) the
    # sort leaves the lower id first; equal keys may come in any order, so
    # put the copy first there.
    swapped = 0
    for tile in range(order.shape[0]):
        at = {int(c): k for k, c in
              enumerate(order[tile, :counts[tile]].tolist())}
        if 0 in at and 2 in at and at[0] < at[2] \
                and keys[tile, at[0]] == keys[tile, at[2]]:
            order[tile, at[0]], order[tile, at[2]] = 2, 0
            swapped += 1
        if 0 in at and 2 in at:
            at = {int(c): k for k, c in
                  enumerate(order[tile, :counts[tile]].tolist())}
            assert at[2] < at[0]  # the copy is scanned before the original
    assert swapped > 0
    t, idx, _ = cuda_scan.scan_sweep(tied, rays_s, perm, order, keys, counts,
                                     512, rays8.shape[1], False)
    assert torch.equal(idx, idx_f) and torch.equal(_bits(t), _bits(t_f))
    t_j, idx_j, _ = cuda_jobs.closest_with_row(tied, rays8)
    assert torch.equal(idx_j, idx_f) and torch.equal(_bits(t_j), _bits(t_f))


@pytest.mark.parametrize("cull", CULLS)
def test_exact_tie_inside_a_tile_goes_to_the_lowest_index(grid_wt,  # noqa: F811
                                                          cull):
    """Copies of a triangle one and 32 indices up in its own tile tie with it
    exactly on every lane that hits it: through the scan path the original
    wins, as in the full sweep; occlusion is unchanged; and the JAX `_run2`
    agrees on hits, t and occlusion, its winners differing only between a
    triangle and its copy or on other f64 near-ties."""
    wt, tables, copies, ro, rd, t_max = tie_case(grid_wt)
    rays8 = stack8(ro, rd, t_max)
    t_f, idx_f = closest_plain(tables, rays8)
    hit = (idx_f >= 0).numpy()
    tied = np.zeros_like(hit)
    tied[hit] = np.isin(idx_f.numpy()[hit], np.nonzero(copies)[0] - 1) \
        | np.isin(idx_f.numpy()[hit], np.nonzero(copies)[0] - 32)
    assert int(tied.sum()) > 300 and not copies[idx_f.numpy()[hit]].any()

    t, idx, rows = cuda_scan.closest_with_row(tables, rays8, m=512,
                                              cull=cull)
    assert torch.equal(idx, idx_f) and torch.equal(_bits(t), _bits(t_f))
    assert torch.equal(_bits(rows), _bits(rows_plain(tables.shade_table,
                                                     idx_f)))
    occ = cuda_scan.shadow(tables, rays8, m=512, cull=cull)
    assert torch.equal(occ, shadow_plain(tables, rays8))

    t_j, i_j, _ = (np.asarray(a) for a in _jax_run2(wt, ro, rd, t_max,
                                                     False))
    np.testing.assert_array_equal(i_j >= 0, hit)
    differ = np.nonzero(hit & (idx.numpy() != i_j))[0]
    assert_near_ties(tables.shade_table.numpy(), ro.T, rd.T, i_j,
                     idx.numpy(), differ)
    np.testing.assert_allclose(t.numpy()[hit], t_j[hit], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(_jax_run2(wt, ro, rd, t_max, True)))
