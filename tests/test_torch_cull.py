"""The job-stream path's coherence sort and exact cull against the JAX
package, on the CPU.

Fixtures: tests/test_two_level.py's grid (random rays), ladder (one winner
cluster per lane) and drain worlds, and the fused bounce-1 ray stacks of
mixed (35 tiles) and spheres (2,009 tiles) at 16^2, advanced through the
port's plain path.

- Sort key: the port's `sort_key` against the JAX key, recomputed here from
  the lines of `pallas_dense._coherence_sort`, at g = 128 and 256 (both
  segment cases: the split lane a multiple of g or not; padded lanes).
  Equal on >= 99.9% of live lanes: XLA's CPU backend may contract
  `rdx * rdx + ...` into FMAs, which can move a lane across a direction
  bin edge. The sort decides speed only (the cull is conservative), so it
  may differ a little; the narrow phase may not. Dead and padded lanes
  sort to their segment's end in both packages; where the live lanes'
  keys are all equal, the inverse permutations are equal.
- Cull: `worklists_plain` against JAX `tile_cluster_worklist_exact(...,
  with_keys=False)` on the same sorted rays: counts equal on >= 99% of
  groups, each JAX worklist contained in the port's but for clusters whose
  test sits within 1e-5 relative of its threshold, and on every fixture
  the cluster of each lane's `closest_plain` winner is on its group's
  worklist. The ladder's worklists are as short as JAX's.
- The plain helpers beside the CUDA culls: the tables' `box` is
  `scene_box(spheres)` bit for bit, and the sort and both plain culls give
  the same with it as with a box reduced anew; `place_survivors` (the
  unkeyed kernel's bit-mask placement, restated here in plain PyTorch)
  gives `worklists_plain`'s lists, on every fixture and on random maps at
  ragged cluster counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops.cluster_cull import tile_cluster_worklist_exact
from webgpu_raytracer_tpu.ops.pallas_dense import (_coherence_sort,
                                                   rayf_from_components)
from webgpu_raytracer_tpu.ops.tune import TuneConfig as JaxTune
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (keys_plain,
                                                         lane_terms,
                                                         worklists_plain)
from webgpu_raytracer_tpu_torch.ops import tune as port_tune
from webgpu_raytracer_tpu_torch.ops.coherence import (box6, coherence_sort,
                                                      scene_box, sort_key)
from webgpu_raytracer_tpu_torch.ops.dense import (T_MIN, closest_plain,
                                                  worklist_mask)

from tests.test_two_level import (drain_world, grid_wt,  # noqa: F401
                                  ladder_world)
from tests.torch_common import job_cases, stack8

CASES = ("grid", "ladder", "drain", "mixed", "spheres")


@pytest.fixture(scope="module")
def cases(grid_wt, ladder_world, drain_world):  # noqa: F811
    return job_cases(grid_wt, ladder_world, drain_world)


def _jax_key(ro, rd, t_max, m_tile, seg_start, sph_flat, tune):
    """The sort key of `pallas_dense._coherence_sort` (its key lines at the
    default `key_mode="obox"` and `dir_bits=2`, verbatim), as numpy."""
    assert tune.key_mode == "obox" and tune.dir_bits > 1
    rox, roy, roz = (jnp.asarray(c) for c in ro)
    rdx, rdy, rdz = (jnp.asarray(c) for c in rd)
    t_max = jnp.asarray(t_max)
    R = rox.shape[0]
    r_pad = (-R) % m_tile
    if r_pad:
        rox, roy, roz, rdx, rdy, rdz, t_max = (
            jnp.pad(x, (0, r_pad))
            for x in (rox, roy, roz, rdx, rdy, rdz, t_max))
    rp = R + r_pad
    live = sph_flat[:, 3] >= 0.0
    smin = jnp.min(jnp.where(live[:, None], sph_flat[:, 0:3]
                             - sph_flat[:, 3:4], jnp.float32(3e38)), axis=0)
    sext = jnp.maximum(
        jnp.max(jnp.where(live[:, None], sph_flat[:, 0:3] + sph_flat[:, 3:4],
                          jnp.float32(-3e38)), axis=0) - smin, 1e-20)
    lane_live = t_max > 0.0
    key = jnp.zeros((rp,), jnp.int32)
    octant = jnp.zeros((rp,), jnp.int32)
    for a, (o_c, d_c) in enumerate(((rox, rdx), (roy, rdy), (roz, rdz))):
        cl = 1 << tune.cell_bits
        o_lo = jnp.min(jnp.where(lane_live, o_c, jnp.float32(3e38)))
        o_ext = jnp.maximum(
            jnp.max(jnp.where(lane_live, o_c, jnp.float32(-3e38)))
            - o_lo, 1e-20)
        cell_w = jnp.maximum(
            o_ext * (1.0 / cl),
            sext[a] * (2.0 ** -tune.cell_floor_bits))
        q = jnp.clip(((o_c - o_lo) / cell_w)
                     .astype(jnp.int32), 0, cl - 1)
        key = key * cl + q
        dl_all = jnp.sqrt(rdx * rdx + rdy * rdy + rdz * rdz)
        dn = d_c / jnp.maximum(dl_all, 1e-20)
        lv = 1 << tune.dir_bits
        qd = jnp.clip(((dn + 1.0) * (0.5 * lv)).astype(jnp.int32),
                      0, lv - 1)
        octant = octant * lv + qd
    dir_span = 1 << (3 * tune.dir_bits)
    cell_span = 1 << (3 * tune.cell_bits)
    key = octant * cell_span + key
    key = jnp.where(t_max > 0.0, key, jnp.int32(cell_span * dir_span))
    seg = (jnp.arange(rp, dtype=jnp.int32) >= seg_start).astype(jnp.int32)
    return np.asarray(key + seg * jnp.int32(2 * cell_span * dir_span))


def test_tune_constants_are_the_jax_defaults():
    """The port keeps one sort key and one group size per narrow phase:
    the JAX package's defaults."""
    jt = JaxTune()
    assert (jt.key_mode, jt.narrow) == ("obox", "jobs")
    assert (port_tune.DIR_BITS, port_tune.CELL_BITS,
            port_tune.CELL_FLOOR_BITS, port_tune.M_TILE3) == (jt.dir_bits, jt.cell_bits, jt.cell_floor_bits,
                              jt.m_tile3)
    # The scan path's tile size and the cone cull's subtile.
    assert (port_tune.M_TILE2, port_tune.SUBTILE) == (jt.m_tile2, jt.subtile)


def _segment_start(split, g):
    return split if split % g == 0 else 0


def _jax_sort(tables, ro, rd, t_max, g, seg):
    """JAX `_coherence_sort`: (sorted t_max (rp,), inv_perm (rp,))."""
    c = lambda a: tuple(jnp.asarray(a[k]) for k in range(3))  # noqa: E731
    comps, _, _, inv_perm, _, _, _ = _coherence_sort(
        c(ro), c(rd), jnp.asarray(t_max), jnp.asarray(t_max > 0), g, seg,
        jnp.asarray(tables.spheres.numpy()), JaxTune(m_tile3=g))
    return np.asarray(comps[6]), np.asarray(inv_perm)


def _live_prefix(t_sorted, seg, n_lanes):
    """Every segment's live lanes (t_max > 0) come first."""
    for lo, hi in ((0, seg), (seg, n_lanes)):
        live = t_sorted[lo:hi] > 0
        assert not (~live[:-1] & live[1:]).any(), (lo, hi)


def _assert_keys_match(case_rays, g, seg):
    """The port's key against the JAX lines': equal on dead and padded
    lanes, and on >= 99.9% of live ones. Returns (rays8, rp)."""
    tables, ro, rd, t_max, _ = case_rays
    want = _jax_key(ro, rd, t_max, g, seg, jnp.asarray(tables.spheres.numpy()),
                    JaxTune(m_tile3=g))
    rays8 = stack8(ro, rd, t_max)
    rp = want.size
    padded = torch.nn.functional.pad(rays8, (0, rp - rays8.shape[1]))
    got = sort_key(padded, tables.box, seg).numpy()
    live = padded[6].numpy() > 0
    assert live.any() and (~live).any()
    np.testing.assert_array_equal(got[~live], want[~live])
    agree = (got[live] == want[live]).mean()
    assert agree >= 0.999, f"keys agree on {agree:.4%} of live lanes"
    return rays8, rp


@pytest.mark.parametrize("g", [128, 256])
@pytest.mark.parametrize("case", CASES)
def test_sort_key_matches_jax(cases, case, g):
    tables, ro, rd, t_max, split = cases[case]
    seg = _segment_start(split, g)
    rays8, rp = _assert_keys_match(cases[case], g, seg)

    # Dead and padded lanes at the end of their segment, in both packages.
    rays_s, perm = coherence_sort(rays8, tables.box, g, seg)
    assert rays_s.shape[1] == rp and rp % g == 0
    _live_prefix(rays_s[6].numpy(), seg, rp)
    t_j, _ = _jax_sort(tables, ro, rd, t_max, g, seg)
    _live_prefix(t_j, seg, rp)
    # The padding (the highest lanes, dead) sorts last of all.
    pad_pos = np.nonzero(perm.numpy() >= rays8.shape[1])[0]
    np.testing.assert_array_equal(pad_pos,
                                  np.arange(rays8.shape[1], rp))
    assert sorted(perm.tolist()) == list(range(rp))


@pytest.mark.parametrize("seg", [0, 512])
def test_inverse_permutation_matches_jax_on_equal_keys(cases, seg):
    """Live lanes share one key (one origin, one direction); dead lanes are
    scattered: both stable sorts move the dead lanes to the end of their
    segment in the same order."""
    tables = cases["grid"][0]
    R = 1000
    lane = np.arange(R)
    ro = np.tile(np.float32([[0.1], [0.6], [-0.2]]), (1, R))
    rd = np.tile(np.float32([[0.3], [-0.8], [0.1]]), (1, R))
    t_max = np.where((lane % 7 == 3) | (lane % 11 == 0), 0.0,
                     1e30).astype(np.float32)
    _, inv_j = _jax_sort(tables, ro, rd, t_max, 128, seg)
    _, perm = coherence_sort(stack8(ro, rd, t_max), tables.box, 128,
                             seg)
    inv = torch.argsort(perm.long()).numpy()
    np.testing.assert_array_equal(inv, inv_j)
    assert not np.array_equal(inv, np.arange(inv.size))


def _sorted_case(cases, case, g=128):
    tables, ro, rd, t_max, split = cases[case]
    seg = _segment_start(split, g)
    rays_s, _ = coherence_sort(stack8(ro, rd, t_max), tables.box, g, seg)
    return tables, rays_s


def _jax_worklists(tables, rays_s, g):
    rs = [jnp.asarray(rays_s[k].numpy()) for k in range(7)]
    rayf = rayf_from_components(rs[3], rs[4], rs[5], rs[0], rs[1], rs[2])
    order, _, counts = tile_cluster_worklist_exact(
        rayf, rs[6], jnp.asarray(tables.spheres.numpy()), g, with_keys=False)
    return torch.from_numpy(np.array(order)), torch.from_numpy(
        np.array(counts))


def _near_threshold(rays_s, t_clip, sphere, lanes, rel=1e-5):
    """Some lane's pair test passes when each comparison is relaxed by
    `rel` of its terms' magnitude (f64)."""
    r = rays_s[:, lanes].double().numpy()
    d, o = r[0:3], r[3:6]
    c, rad = sphere[:3].double().numpy()[:, None], float(sphere[3])
    oc = o - c
    b = (d * oc).sum(0)
    dd = (d * d).sum(0)
    cc = (oc * oc).sum(0) - rad * rad
    disc = b * b - dd * cc
    tol_disc = rel * (b * b + np.abs(dd * cc))
    tc = t_clip[lanes].double().numpy()
    a_lo = dd * T_MIN + b
    b_hi = dd * tc + b
    ok_lo = (a_lo <= rel * (np.abs(dd * T_MIN) + np.abs(b))) | (
        disc >= a_lo * a_lo - tol_disc - rel * a_lo * a_lo)
    ok_hi = (b_hi >= -rel * (np.abs(dd * tc) + np.abs(b))) | (
        disc >= b_hi * b_hi - tol_disc - rel * b_hi * b_hi)
    return bool(((disc >= -tol_disc) & (tc > 0) & ok_lo & ok_hi).any())


@pytest.mark.parametrize("case", CASES)
def test_cull_matches_jax(cases, case):
    g = 128
    tables, rays_s = _sorted_case(cases, case, g)
    order, counts = worklists_plain(tables.spheres, rays_s, g, tables.box)
    order_j, counts_j = _jax_worklists(tables, rays_s, g)
    ct = tables.spheres.shape[0]
    assert order.shape == order_j.shape == (rays_s.shape[1] // g, ct)
    same = (counts == counts_j).float().mean()
    assert same >= 0.99, f"{case}: counts equal on {same:.2%} of groups"
    mine = worklist_mask(order, counts, ct)
    theirs = worklist_mask(order_j, counts_j, ct)
    pos = torch.arange(ct)[None, :] < counts[:, None]
    assert torch.equal(torch.where(pos, order, -1),
                       torch.where(pos, torch.sort(
                           torch.where(pos, order, ct), 1).values, -1))
    _, t_clip = lane_terms(rays_s, tables.box)
    for grp, cl in torch.nonzero(theirs & ~mine).tolist():
        lanes = np.arange(grp * g, (grp + 1) * g)
        assert _near_threshold(rays_s, t_clip, tables.spheres[cl], lanes), \
            f"{case}: cluster {cl} dropped from group {grp}"
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("case", CASES)
def test_cull_keeps_every_winners_cluster(cases, case):
    """The property that matters: each lane's closest hit (the full plain
    sweep) lies in a cluster on its group's worklist."""
    g = 128
    tables, rays_s = _sorted_case(cases, case, g)
    order, counts = worklists_plain(tables.spheres, rays_s, g, tables.box)
    _, idx = closest_plain(tables, rays_s)
    hit = torch.nonzero(idx >= 0).flatten()
    assert hit.numel() > 0
    mask = worklist_mask(order, counts, tables.spheres.shape[0])
    assert mask[hit // g, idx[hit].long() // 128].all()
    # A worklist never holds an all-padding tile, and dead groups none.
    assert not mask[:, tables.spheres[:, 3] < 0].any()
    dead = (rays_s[6].view(-1, g) <= 0).all(1)
    assert (counts[dead] == 0).all()


@pytest.mark.parametrize("g", [128, 256])
def test_ladder_worklists_as_short_as_jax(cases, g):
    """Each group lists only its lanes' patches and the environment, never
    more than the 7 clusters of the JAX test's one 512-lane tile, and the
    groups together cover all 7; a group of dead lanes lists nothing."""
    tables, rays_s = _sorted_case(cases, "ladder", g)
    order, counts = worklists_plain(tables.spheres, rays_s, g, tables.box)
    _, counts_j = _jax_worklists(tables, rays_s, g)
    np.testing.assert_array_equal(counts.numpy(), counts_j.numpy())
    assert (counts < 7).all()
    dead = (rays_s[6].view(-1, g) <= 0).all(1)
    assert (counts[dead] == 0).all() and (counts[~dead] > 0).all()
    assert dead.any() == (g == 128)
    assert worklist_mask(order, counts, 7).any(0).all()


@pytest.mark.parametrize("case", CASES)
def test_tables_box_is_the_scene_box(cases, case):
    """`WorldTables.box`, computed once when the tables are built, is
    `scene_box(spheres)` bit for bit; sort, cull and keyed cull give the
    same with it as with the box reduced anew on the spot."""
    tables, ro, rd, t_max, split = cases[case]
    lo, hi = scene_box(tables.spheres)
    assert tables.box.shape == (6,) and tables.box.dtype == torch.float32
    assert torch.equal(tables.box, torch.cat([lo, hi]))
    assert torch.equal(tables.box, box6(tables.spheres))
    assert (lo < hi).all()
    g = 128
    seg = _segment_start(split, g)
    rays8 = stack8(ro, rd, t_max)
    rays_s, perm = coherence_sort(rays8, tables.box, g, seg)
    anew = box6(tables.spheres.clone())
    rays_b, perm_b = coherence_sort(rays8, anew, g, seg)
    assert torch.equal(perm, perm_b) and torch.equal(rays_s, rays_b)
    for plain in (worklists_plain, keys_plain):
        a = plain(tables.spheres, rays_s, g, anew)
        b = plain(tables.spheres, rays_s, g, tables.box)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), plain.__name__


def place_survivors(possible: torch.Tensor):
    """(order (G, Ct) int32, counts (G,) int32) from a (G, Ct) bool map, the
    way `csrc/cluster_cull.cu` places them: the map as 32-bit words, an
    exclusive prefix over the words' popcounts, and each set bit at that
    prefix plus the count of set bits below it in its word. Row g starts
    with its counts[g] survivors in ascending id; the rest is -1 here (the
    kernel leaves it unwritten)."""
    G, ct = possible.shape
    nw = -(-ct // 32)
    bits = torch.zeros((G, nw * 32), dtype=torch.int64)
    bits[:, :ct] = possible
    bits = bits.view(G, nw, 32)
    pop = bits.sum(2)
    before = pop.cumsum(1) - pop
    below = bits.cumsum(2) - bits
    place = (before[:, :, None] + below).view(G, -1)
    ids = torch.arange(nw * 32).expand(G, -1)
    order = torch.full((G, ct), -1, dtype=torch.int32)
    hit = bits.view(G, -1) > 0
    rows = torch.arange(G)[:, None].expand(G, nw * 32)
    order[rows[hit], place[hit]] = ids[hit].to(torch.int32)
    return order, pop.sum(1).to(torch.int32)


def _assert_placed(possible, order_want, counts_want):
    order, counts = place_survivors(possible)
    ct = possible.shape[1]
    assert order.dtype == counts.dtype == torch.int32
    assert torch.equal(counts, counts_want)
    pos = torch.arange(ct)[None, :] < counts[:, None]
    assert torch.equal(order, torch.where(pos, order_want, -1))


@pytest.mark.parametrize("case", CASES)
def test_place_survivors_matches_the_plain_cull(cases, case):
    g = 128
    tables, rays_s = _sorted_case(cases, case, g)
    order, counts = worklists_plain(tables.spheres, rays_s, g, tables.box)
    possible = worklist_mask(order, counts, tables.spheres.shape[0])
    assert possible.any()
    _assert_placed(possible, order, counts)


@pytest.mark.parametrize("ct", [1, 31, 32, 33, 2009])
def test_place_survivors_on_random_maps(ct):
    """Rows that are empty, full and random, at cluster counts around the
    32-bit word's edge: the lists of a stable sort by (dropped, id)."""
    rs = np.random.default_rng(ct)
    possible = torch.from_numpy(rs.random((12, ct)) < 0.3)
    possible[0] = False
    possible[1] = True
    ids = torch.arange(ct, dtype=torch.int32)
    key = torch.where(possible, ids[None, :], ct)
    order = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    _assert_placed(possible, order, possible.sum(1, dtype=torch.int32))
