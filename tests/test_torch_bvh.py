"""The port's BVH path against the JAX package's, on the CPU.

- `build_device_scene`: every array equal to JAX's, for cornell, special,
  mesh, viewer and the textured quad (level-0 quad table).
- `ops/bsdf.py` (the (R, 3) form): each function on random inputs against
  JAX's at rtol 1e-5 (sin / cos / sqrt may differ by ulps between XLA and
  ATen), roughness in [0.3, 1); near-mirror GGX (roughness 0.005) at rtol
  5e-2, as tests/test_torch_shade.py holds it.
- `intersect_closest` / `intersect_shadow`: against tests/oracle.py at
  tests/test_intersect.py's thresholds, rays and seeds (7 / 11, 256 / 512
  rays, the same four presets), and against JAX: the same (tri, inst) on
  every lane whose winner is not an f64 near-tie, t at rtol 1e-4 (XLA sums
  a dot product and an einsum in its own order, the port left to right);
  the same occlusion; inactive lanes hit nothing. The plain walk's
  working-set compaction leaves every lane's result and counts as they
  are.
- `pack_walk` (the walk kernel's records) unpacks bit for bit to the
  scene's arrays, with e1 and e2 torch's f32 differences; the walks and
  `trace_pixels` give the same with a pack given as without; the slab test
  with fmin / fmax (the kernel's test on finite rays) gives the same
  answers as `aabb_hit` on finite lanes, extreme magnitudes included; and
  on lanes with NaN or inf in o, d or t_max the plain walk equals JAX, its
  counts those of the TLAS root's skip chain (the semantics the kernel's
  exact path keeps).
- `load_hit`, `sample_light_source`, `get_light_pdf`, `sample_texture`
  against JAX at rtol 1e-5.
- `trace_pixels` against JAX `trace_pixels` at cornell 16^2 d3 spp 2 and
  the textured quad 16^2 d3, frames 1..2, with the tolerance of
  tests/test_torch_slice.py (>= 95% of lanes at rel < 1e-3, means and ray
  counts within 2%), and the port's BVH frame against its dense frame, as
  tests/test_dense.py holds JAX's two backends.
- max_depth 0: the BVH loop runs no bounce (zero radiance, R rays), the
  dense loop one shadow-only bounce, in both packages.
- `trace_pixels_dense` with the sharding offsets against JAX's with the
  same offsets, and row bands / sample slices that put the whole frame
  back together bit for bit.
- `choose_backend`'s table, and `get_tracer`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.models.native import NativeWorld as JaxWorld
from webgpu_raytracer_tpu.ops import bsdf as jb
from webgpu_raytracer_tpu.ops import trace as jt
from webgpu_raytracer_tpu.ops.dense_trace import \
    trace_pixels_dense as jax_dense
from webgpu_raytracer_tpu.ops.intersect import \
    intersect_closest as jax_closest
from webgpu_raytracer_tpu.ops.intersect import \
    intersect_shadow as jax_shadow
from webgpu_raytracer_tpu.render.resources import \
    build_device_scene as jax_scene
from webgpu_raytracer_tpu.utils import textures as jax_textures
from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch.ops import bsdf as tb
from webgpu_raytracer_tpu_torch.ops import trace as pt
from webgpu_raytracer_tpu_torch.ops.api import (DENSE_MAX_TRIS,
                                                choose_backend, get_tracer)
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu_torch.ops.intersect import (aabb_hit,
                                                      intersect_closest,
                                                      intersect_shadow,
                                                      pack_walk, safe_inv,
                                                      traverse_plain,
                                                      walk_cuda)
from webgpu_raytracer_tpu_torch.render.resources import build_device_scene
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables

from tests.glb_fixture import textured_quad_glb
from tests.oracle import intersect_brute, unpack_world
from tests.test_intersect import random_rays
from tests.torch_common import jax_and_port_tables

_jax_trace = jax.jit(jt.trace_pixels, static_argnames=(
    "width", "height", "spp", "max_depth", "with_stats", "full_height",
    "total_spp"))
_jax_dense = jax.jit(jax_dense, static_argnames=(
    "width", "height", "spp", "max_depth", "with_stats", "full_height",
    "total_spp"))

SCENES = {"cornell": ("cornell", None), "special": ("special", None),
          "mesh": ("mesh", None), "viewer": ("viewer", None),
          "textured": ("viewer", textured_quad_glb)}


def _scenes(case, res=None):
    """(JAX world, JAX DeviceScene, port world, port DeviceScene on the
    CPU), each package decoding and packing the textures itself."""
    name, glb = SCENES[case]
    data = glb() if glb else None
    jw, pw = JaxWorld(name, glb_data=data), NativeWorld(name, glb_data=data)
    if res is not None:
        jw.update_camera(res, res)
        pw.update_camera(res, res)
    jtex = ptex = None
    if glb is not None:
        jtex = jax_textures.pack_quad_table(
            jax_textures.decode_world_textures(jw))
        from webgpu_raytracer_tpu_torch.utils import textures as port_tex
        ptex = port_tex.decode_world_textures(pw)
    return (jw, jax_scene(jw, textures=jtex), pw,
            build_device_scene(pw, textures=ptex, device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", sorted(SCENES))
def test_build_device_scene_bit_equal_to_jax(case):
    _, js, _, ps = _scenes(case)
    assert js._fields == ps._fields
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), _np(getattr(ps, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if a.dtype == np.uint32:  # the quad table: words below 2**24
            a = a.astype(np.int64)
        np.testing.assert_array_equal(b, a, err_msg=f)
    if case == "textured":
        assert tuple(ps.textures.shape) == (1, 1024, 1024, 4)
    else:
        assert tuple(ps.textures.shape) == (1, 1, 1, 3)


def test_padded_nodes_are_empty_boxes():
    _, _, pw, ps = _scenes("cornell")
    n = ps.node_min.shape[0]
    real = len(np.asarray(pw.tlas())) // 8 + len(np.asarray(pw.blas())) // 8
    assert n % 256 == 0 and real < n
    assert (ps.node_min[real:] == 0).all() and (ps.node_max[real:] == -1).all()
    assert (ps.node_skip[real:] == n).all() and (ps.node_data[real:] == 0).all()


# -- bsdf ---------------------------------------------------------------------

BSDF_CASES = ["normalize", "reflect", "refract", "onb", "cosine", "disk",
              "diffuse", "ggx_terms", "ggx_eval", "ggx_pdf", "ggx_sample",
              "dielectric", "power", "near_mirror"]


def _close(t, j, what, rtol=1e-5):
    if isinstance(t, tuple):
        for a, b in zip(t, j):
            _close(a, b, what, rtol)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("case", BSDF_CASES)
def test_bsdf_matches_jax(case):
    rs = np.random.default_rng(100 + BSDF_CASES.index(case))
    n = 4096

    def unit():
        v = rs.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)) \
            .astype(np.float32)

    nv, vv = unit(), unit()
    vv = vv * np.where((nv * vv).sum(1) < 0.0, -1.0, 1.0)[:, None] \
        .astype(np.float32)
    alb = rs.uniform(0.05, 1.0, size=(n, 3)).astype(np.float32)
    r1, r2 = (rs.uniform(size=n).astype(np.float32) for _ in range(2))
    rough = rs.uniform(0.3, 1.0, size=n).astype(np.float32)
    ior = rs.uniform(1.1, 2.4, size=n).astype(np.float32)
    J = {k: jnp.asarray(v) for k, v in dict(
        n=nv, v=vv, a=alb, r1=r1, r2=r2, ro=rough, ior=ior).items()}
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        n=nv, v=vv, a=alb, r1=r1, r2=r2, ro=rough, ior=ior).items()}
    if case == "normalize":
        _close(tb.normalize(T["a"]), jb.normalize(J["a"]), case)
    elif case == "reflect":
        _close(tb.reflect(T["v"], T["n"]), jb.reflect(J["v"], J["n"]), case)
    elif case == "refract":
        _close(tb.refract(-T["v"], T["n"], 1.0 / T["ior"]),
               jb.refract(-J["v"], J["n"], 1.0 / J["ior"]), case)
    elif case == "onb":
        _close(tb.build_onb(T["n"]), jb.build_onb(J["n"]), case)
    elif case == "cosine":
        _close(tb.cosine_hemisphere(T["n"], T["r1"], T["r2"]),
               jb.cosine_hemisphere(J["n"], J["r1"], J["r2"]), case)
    elif case == "disk":
        _close(tb.random_in_unit_disk(T["r1"], T["r2"]),
               jb.random_in_unit_disk(J["r1"], J["r2"]), case)
    elif case == "diffuse":
        st = tb.sample_diffuse(T["n"], T["a"], T["r1"], T["r2"])
        sj = jb.sample_diffuse(J["n"], J["a"], J["r1"], J["r2"])
        _close(st[:3], sj[:3], case)
        assert not st.is_specular.any()
        _close(tb.eval_diffuse(T["a"]), jb.eval_diffuse(J["a"]), case)
    elif case == "ggx_terms":
        a2t, a2j = T["ro"] * T["ro"], J["ro"] * J["ro"]
        _close(tb.ggx_d(T["r1"], a2t), jb.ggx_d(J["r1"], a2j), case)
        _close(tb.ggx_g(T["r1"], T["r2"], a2t), jb.ggx_g(J["r1"], J["r2"],
                                                        a2j), case)
        _close(tb.fresnel_schlick(T["r1"], T["a"]),
               jb.fresnel_schlick(J["r1"], J["a"]), case)
        _close(tb.reflectance_dielectric(T["r1"], T["ior"]),
               jb.reflectance_dielectric(J["r1"], J["ior"]), case)
    elif case == "ggx_eval":
        _close(tb.eval_ggx(T["n"], T["v"], T["a"], T["ro"], T["a"]),
               jb.eval_ggx(J["n"], J["v"], J["a"], J["ro"], J["a"]), case)
    elif case == "ggx_pdf":
        _close(tb.ggx_pdf(T["n"], T["v"], T["a"], T["ro"]),
               jb.ggx_pdf(J["n"], J["v"], J["a"], J["ro"]), case)
    elif case in ("ggx_sample", "near_mirror"):
        rtol = 5e-2 if case == "near_mirror" else 1e-5
        ro_t = torch.full_like(T["ro"], 0.005) if rtol > 1e-5 else T["ro"]
        ro_j = jnp.asarray(ro_t.numpy())
        st = tb.sample_ggx(T["n"], T["v"], ro_t, T["a"], T["r1"], T["r2"])
        sj = jb.sample_ggx(J["n"], J["v"], ro_j, J["a"], J["r1"], J["r2"])
        keep = np.asarray(sj.pdf) > 0  # the same hemisphere on both
        if rtol > 1e-5:
            keep &= st.pdf.numpy() > 0
            assert keep.mean() > 0.9
        for a, b in zip(st[:3], sj[:3]):
            np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep],
                                       rtol=rtol, atol=1e-6, err_msg=case)
        np.testing.assert_array_equal(st.is_specular.numpy(),
                                      np.asarray(sj.is_specular))
    elif case == "dielectric":
        st = tb.sample_dielectric(T["v"], T["n"], T["ior"], T["a"], T["r1"])
        sj = jb.sample_dielectric(J["v"], J["n"], J["ior"], J["a"], J["r1"])
        _close(st[:3], sj[:3], case)
        assert st.is_specular.all()
    else:
        _close(tb.power_heuristic(T["r1"], T["r2"]),
               jb.power_heuristic(J["r1"], J["r2"]), case)


# -- intersection -------------------------------------------------------------

def _t64(world, ro, rd, tri, inst):
    """f64 Moller-Trumbore t of each lane's (tri, inst) in instance space."""
    tri_v, _, pos, _, inv, _ = unpack_world(world)
    m = inv[inst].astype(np.float64)
    o = np.einsum("rij,rj->ri", m[:, :3, :3], ro) + m[:, :3, 3]
    d = np.einsum("rij,rj->ri", m[:, :3, :3], rd)
    p = pos.astype(np.float64)[tri_v[tri]]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    h = np.cross(d, e2)
    q = np.cross(o - p[:, 0], e1)
    return np.einsum("ij,ij->i", e2, q) / np.einsum("ij,ij->i", e1, h)


def _assert_matches_jax(world, ro, rd, hj, hp):
    tri_j, tri_p = np.asarray(hj.tri_idx), hp.tri_idx.numpy()
    inst_j, inst_p = np.asarray(hj.inst_idx), hp.inst_idx.numpy()
    np.testing.assert_array_equal(tri_p >= 0, tri_j >= 0)
    both = (tri_p >= 0) & (tri_j >= 0)
    np.testing.assert_allclose(hp.t.numpy()[both], np.asarray(hj.t)[both],
                               rtol=1e-4)
    flip = np.nonzero(both & ((tri_p != tri_j) | (inst_p != inst_j)))[0]
    if flip.size:  # near-ties in f64 only
        ro64, rd64 = ro[flip].astype(np.float64), rd[flip].astype(np.float64)
        np.testing.assert_allclose(
            _t64(world, ro64, rd64, tri_p[flip], inst_p[flip]),
            _t64(world, ro64, rd64, tri_j[flip], inst_j[flip]), rtol=1e-5,
            err_msg="a winner that is no near-tie differs from JAX's")
    assert flip.size <= 0.01 * len(tri_p)


@pytest.mark.parametrize("scene_name", ["cornell", "special", "mesh",
                                        "viewer"])
def test_closest_hit_matches_oracle_and_jax(scene_name):
    rng = np.random.default_rng(7)
    jw, js, pw, ps = _scenes(scene_name)
    ro, rd = random_rays(rng, 256)
    hit = intersect_closest(ps, torch.from_numpy(ro), torch.from_numpy(rd))
    t_ref, tri_ref, inst_ref = intersect_brute(
        pw, ro.astype(np.float64), rd.astype(np.float64))
    got_inst, got_tri, got_t = (x.numpy() for x in (hit.inst_idx,
                                                    hit.tri_idx, hit.t))
    miss_ref = inst_ref < 0
    agree = (got_inst >= 0) == ~miss_ref
    assert agree.mean() > 0.99, f"hit/miss disagreement {1 - agree.mean()}"
    both = (~miss_ref) & (got_inst >= 0) & agree
    np.testing.assert_allclose(got_t[both], t_ref[both], rtol=2e-3,
                               atol=2e-4)
    assert (got_tri[both] == tri_ref[both]).mean() > 0.9
    hj = jax_closest(js, jnp.asarray(ro), jnp.asarray(rd))
    _assert_matches_jax(jw, ro, rd, hj, hit)


def test_shadow_consistent_with_closest_and_jax():
    rng = np.random.default_rng(11)
    jw, js, _, ps = _scenes("cornell")
    ro, rd = random_rays(rng, 512, lo=-0.9, hi=0.9)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.05  # inside the box
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    hit = intersect_closest(ps, ro_t, rd_t)
    t, has_hit = hit.t, hit.inst_idx >= 0
    occ = intersect_shadow(ps, ro_t, rd_t, t_max=t + 1e-2)
    assert occ[has_hit].all()
    short = torch.clamp(t * 0.5, min=2e-3)
    occ2 = intersect_shadow(ps, ro_t, rd_t, t_max=short)
    assert not occ2[has_hit].any()
    for t_max, got in ((t + 1e-2, occ), (short, occ2)):
        want = jax_shadow(js, jnp.asarray(ro), jnp.asarray(rd),
                          t_max=jnp.asarray(t_max.numpy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_inactive_lanes_do_not_hit():
    _, _, _, ps = _scenes("cornell")
    ro = torch.zeros((8, 3)) + torch.tensor([0.0, 1.0, 0.0])
    rd = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    active = torch.tensor([True, False] * 4)
    hit, stats = intersect_closest(ps, ro, rd, active=active,
                                   with_stats=True)
    assert (hit.inst_idx[::2] >= 0).all() and (hit.inst_idx[1::2] == -1).all()
    assert (hit.t[1::2] == 1e30).all()
    assert (stats.nodes[1::2] == 0).all() and (stats.nodes[::2] > 0).all()
    occ = intersect_shadow(ps, ro, rd, t_max=torch.full((8,), 10.0),
                           active=active)
    assert occ[::2].all() and not occ[1::2].any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_lanes_are_independent(any_hit):
    """The plain walk drops finished lanes as its set halves: each lane's
    (t, tri, inst) or occlusion and its counts are the same when it walks
    with every other lane, with half of them, or with one."""
    _, _, _, ps = _scenes("mesh")
    rng = np.random.default_rng(5)
    ro, rd = (torch.from_numpy(x) for x in random_rays(rng, 300))
    t_max = torch.from_numpy(rng.uniform(0.5, 8.0, 300).astype(np.float32))
    active = torch.from_numpy(np.arange(300) % 7 != 0)

    def walk(sel):
        return traverse_plain(ps, ro[sel], rd[sel], 1e-3, t_max[sel],
                              active[sel], any_hit)

    full, stats = walk(slice(None))
    assert int(stats.nodes.sum()) > 300 and int(stats.tris.sum()) > 0
    for sel in (slice(0, 150), slice(150, 300), slice(37, 38)):
        part, st = walk(sel)
        for a, b in zip((part, *st) if any_hit else (*part, *st),
                        (full[sel], stats.nodes[sel], stats.tris[sel])
                        if any_hit else (*(x[sel] for x in full),
                                         stats.nodes[sel], stats.tris[sel])):
            assert torch.equal(a, b)


# -- the walk kernel's pack and its slab test ---------------------------------

@pytest.mark.parametrize("case", sorted(SCENES))
def test_pack_walk_unpacks_bit_for_bit(case):
    _, _, _, ps = _scenes(case)
    pk = pack_walk(ps)
    i32 = torch.int32
    n, t, i = (ps.node_min.shape[0], ps.tri_v.shape[0],
               ps.inst_inv.shape[0])
    assert pk.nodes.shape == (n, 8) and pk.nodes.dtype == i32
    assert pk.tris.shape == (t, 12) and pk.tris.dtype == torch.float32
    assert pk.insts.shape == (i, 16) and pk.insts.dtype == i32
    assert pk.tlas_end == ps.tlas_count and int(pk.finite) == 1
    assert torch.equal(pk.nodes[:, 0:3], ps.node_min.view(i32))
    assert torch.equal(pk.nodes[:, 3], ps.node_skip)
    assert torch.equal(pk.nodes[:, 4:7], ps.node_max.view(i32))
    assert torch.equal(pk.nodes[:, 7], ps.node_data)
    p = ps.pos[ps.tri_v.long()]
    rec = pk.tris.view(t, 3, 4)
    assert torch.equal(rec[:, :, 3], torch.zeros(t, 3))
    assert torch.equal(rec[:, 0, :3].view(i32), p[:, 0].view(i32))
    for k in (1, 2):  # e1, e2: one f32 subtraction each, as the walk's
        want = (p[:, k].numpy() - p[:, 0].numpy()).view(np.int32)
        np.testing.assert_array_equal(rec[:, k, :3].view(i32).numpy(), want)
    np.testing.assert_array_equal(
        pk.insts[:, :12].view(torch.float32).view(i, 3, 4).numpy(),
        ps.inst_inv[:, :3, :].numpy())
    assert torch.equal(pk.insts[:, 12], ps.inst_blas)
    assert torch.equal(pk.insts[:, 13],
                       ps.node_skip[ps.inst_blas.clamp(0, n - 1).long()])
    assert (pk.insts[:, 14:] == 0).all()
    bad = ps._replace(node_max=ps.node_max.clone())
    bad.node_max[0, 1] = float("inf")
    assert int(pack_walk(bad).finite) == 0


def _random_rays(scene, n, seed):
    """n rays from inside the scene's box, every 7th with a zero direction
    component (which safe_inv nudges), t_max per lane, every 5th dead."""
    rs = np.random.default_rng(seed)
    lo, hi = scene.node_min[0].numpy(), scene.node_max[0].numpy()
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    ro = (mid + 0.8 * half * rs.uniform(-1, 1, (n, 3))).astype(np.float32)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd[::7, 1] = 0.0
    t_max = rs.uniform(0.1, 2.0 * float(half.max()), n).astype(np.float32)
    active = np.arange(n) % 5 != 0
    return tuple(torch.from_numpy(x) for x in (ro, rd, t_max, active))


@pytest.mark.parametrize("name", ["cornell", "spheres"])
def test_walks_with_a_pack_equal_the_walks_without(name):
    """The entry points with the pack given and without (the CPU walks the
    scene's arrays either way) equal the plain walk, results and counts;
    `ray_color` too, bit for bit."""
    world = NativeWorld(name)
    world.update_camera(8, 8)
    ps = build_device_scene(world, device="cpu")
    pk = pack_walk(ps)
    ro, rd, t_max, active = _random_rays(ps, 384, 21)
    plain, pst = traverse_plain(ps, ro, rd, 1e-3, 1e30, active, False)
    assert (plain.inst_idx >= 0).float().mean() > 0.3
    for kw in ({}, {"pack": pk}):
        hit, st = intersect_closest(ps, ro, rd, active=active,
                                    with_stats=True, **kw)
        for a, b in zip((*hit, *st), (*plain, *pst)):
            assert torch.equal(a, b)
    occ_p, ost = traverse_plain(ps, ro, rd, 1e-3, t_max, active, True)
    assert 0 < int(occ_p.sum()) < int(active.sum())
    for kw in ({}, {"pack": pk}):
        occ, st = intersect_shadow(ps, ro, rd, t_max, active=active,
                                   with_stats=True, **kw)
        assert torch.equal(occ, occ_p)
        assert torch.equal(st.nodes, ost.nodes)
        assert torch.equal(st.tris, ost.tris)
    rng = pt.init_rng(torch.arange(ro.shape[0]), 1)
    a, rng_a, ra = pt.ray_color(ps, ro, rd, rng, 3)
    b, rng_b, rb = pt.ray_color(ps, ro, rd, rng, 3, pk)
    assert torch.equal(a, b) and torch.equal(rng_a, rng_b)
    assert float(ra) == float(rb) > ro.shape[0]


def test_walk_rejects_a_pack_of_another_scene():
    """`walk_cuda` holds a given pack to its scene's node, triangle,
    instance and TLAS counts before it launches anything."""
    cornell = build_device_scene(NativeWorld("cornell"), device="cpu")
    mixed = build_device_scene(NativeWorld("mixed"), device="cpu")
    ro, rd, t_max, active = _random_rays(cornell, 8, 5)
    pack, own = pack_walk(mixed), pack_walk(cornell)
    with pytest.raises(ValueError, match="not built from this scene"):
        walk_cuda(cornell, ro, rd, 1e-3, t_max, active, True, pack=pack)
    with pytest.raises(ValueError, match="not built from this scene"):
        walk_cuda(cornell, ro, rd, 1e-3, t_max, active, False,
                  pack=own._replace(tlas_end=own.tlas_end + 1))


def _slab_fast(nmin, nmax, ro, inv_d, t_min, t_max):
    """`aabb_hit` with fmin / fmax, which drop a NaN as fminf / fmaxf do:
    the walk kernel's test on lanes whose o, d and t_max are finite."""
    t1 = (nmin - ro) * inv_d
    t2 = (nmax - ro) * inv_d
    lo, hi = torch.fmin(t1, t2), torch.fmax(t1, t2)
    tn = torch.fmax(torch.fmax(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.fmin(torch.fmin(hi[:, 0], hi[:, 1]), hi[:, 2])
    return torch.fmax(tn, torch.full_like(tn, t_min)) <= torch.fmin(tf,
                                                                   t_max)


@pytest.mark.parametrize("case", ["scene", "extreme"])
def test_fast_slab_test_equals_the_exact_one_on_finite_lanes(case):
    """The kernel's claim 2 (`csrc/bvh_walk.cu`): with o, d finite, t_max
    not NaN and finite node bounds, no min / max operand is NaN, so fmin /
    fmax answer as torch.minimum / torch.maximum do. "extreme" draws
    magnitudes up to 3e38 (b - o overflows), directions down to 1e-38 and
    exact zeros (inv up to 1e20, subnormal reciprocals) and infinite
    t_max."""
    rs = np.random.default_rng(17)
    n = 200_000
    if case == "scene":
        _, _, _, ps = _scenes("mesh")
        pick = torch.from_numpy(rs.integers(0, ps.node_min.shape[0], n))
        nmin, nmax = ps.node_min[pick], ps.node_max[pick]
        ro = torch.from_numpy(rs.uniform(-3, 3, (n, 3)).astype(np.float32))
        rd = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
        t_max = torch.from_numpy(rs.uniform(0, 10, n).astype(np.float32))
    else:
        def wild(shape):
            mag = 10.0 ** rs.uniform(-38, 38.5, shape)
            v = np.sign(rs.normal(size=shape)) * mag
            v[rs.uniform(size=shape) < 0.1] = 0.0
            return np.clip(v, -3e38, 3e38).astype(np.float32)

        a, b = wild((n, 3)), wild((n, 3))
        nmin = torch.from_numpy(np.minimum(a, b))
        nmax = torch.from_numpy(np.maximum(a, b))
        ro, rd = torch.from_numpy(wild((n, 3))), torch.from_numpy(wild((n, 3)))
        t_max = torch.from_numpy(
            np.where(rs.uniform(size=n) < 0.2, np.inf,
                     np.abs(wild((n,)))).astype(np.float32))
    inv = safe_inv(rd)
    assert torch.isfinite(inv).all() and (inv != 0).all()
    exact = aabb_hit(nmin, nmax, ro, inv, 1e-3, t_max)
    assert torch.equal(_slab_fast(nmin, nmax, ro, inv, 1e-3, t_max), exact)
    assert 0 < int(exact.sum()) < n


def _nonfinite_lanes():
    """cornell lanes: a finite ray through the box, then the same with NaN,
    +inf or -inf in each component of o and of d, and with t_max NaN, +inf
    and -inf."""
    o0 = np.array([0.0, 1.0, 3.0], np.float32)
    d0 = np.array([0.0, 0.0, -1.0], np.float32)
    ro, rd, tm = [o0], [d0], [1e30]
    for which in (0, 1):
        for k in range(3):
            for x in (np.nan, np.inf, -np.inf):
                v = (o0 if which == 0 else d0).copy()
                v[k] = x
                ro.append(v if which == 0 else o0)
                rd.append(v if which == 1 else d0)
                tm.append(1e30)
    for x in (np.nan, np.inf, -np.inf):
        ro.append(o0)
        rd.append(d0)
        tm.append(x)
    return (np.stack(ro).astype(np.float32), np.stack(rd).astype(np.float32),
            np.asarray(tm, np.float32))


def _skip_chain(scene):
    """Nodes a lane visits when it misses every box: node 0, then skips
    until the TLAS ends."""
    skip, c, n = scene.node_skip.numpy(), 0, 0
    while c < scene.tlas_count:
        n, c = n + 1, int(skip[c])
    return n


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_on_nonfinite_lanes_matches_jax(any_hit):
    """NaN or inf in o, d or t_max: the plain walk's results equal JAX's on
    the same inputs, and a lane carrying a NaN, or t_max of -inf, misses
    every box, so it visits the TLAS root's skip chain and tests no
    triangle."""
    _, js, _, ps = _scenes("cornell")
    ro, rd, tm = _nonfinite_lanes()
    R = ro.shape[0]
    on = torch.ones(R, dtype=torch.bool)
    out, st = traverse_plain(ps, torch.from_numpy(ro), torch.from_numpy(rd),
                             1e-3, torch.from_numpy(tm), on, any_hit)
    J = (jnp.asarray(ro), jnp.asarray(rd))
    if any_hit:
        want = jax_shadow(js, *J, t_max=jnp.asarray(tm))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert bool(out[0]) and int(out.sum()) == 2  # lane 0 and t_max inf
    else:
        want = jax_closest(js, *J, t_max=jnp.asarray(tm))
        for f in ("t", "tri_idx", "inst_idx"):
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert int(out.inst_idx[0]) == 0
        assert int((out.inst_idx >= 0).sum()) == 2
    nan_lane = np.isnan(ro).any(1) | np.isnan(rd).any(1) | np.isnan(tm) \
        | (tm == -np.inf)
    assert nan_lane.sum() == 8
    chain = _skip_chain(ps)
    np.testing.assert_array_equal(st.nodes.numpy()[nan_lane], chain)
    np.testing.assert_array_equal(st.tris.numpy()[nan_lane], 0)
    assert int(st.nodes[0]) > chain and int(st.tris[0]) > 0


# -- shading helpers ----------------------------------------------------------

def _hits(case, n=512, seed=3):
    jw, js, pw, ps = _scenes(case, res=16)
    cam = np.asarray(pw.camera(), np.float32)
    rs = np.random.default_rng(seed)
    lane = rs.integers(0, 256, n)
    u = ((lane % 16) + rs.uniform(size=n)) / 16
    v = 1.0 - ((lane // 16) + rs.uniform(size=n)) / 16
    rd = np.stack([cam[4 + k] + u * cam[8 + k] + v * cam[12 + k] - cam[k]
                   for k in range(3)], 1).astype(np.float32)
    ro = np.broadcast_to(cam[:3], rd.shape).astype(np.float32)
    h = intersect_closest(ps, torch.from_numpy(ro), torch.from_numpy(rd))
    return jw, js, ps, ro, rd, h, rs


@pytest.mark.parametrize("case", ["cornell", "textured"])
def test_load_hit_matches_jax(case):
    _, js, ps, ro, rd, h, _ = _hits(case)
    hit = h.inst_idx >= 0
    assert hit.float().mean() > 0.5
    a = pt.load_hit(ps, torch.from_numpy(ro), torch.from_numpy(rd),
                    h.tri_idx, h.inst_idx)
    b = jt.load_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                    jnp.asarray(h.tri_idx.numpy()),
                    jnp.asarray(h.inst_idx.numpy()))
    for f in a._fields:
        np.testing.assert_allclose(getattr(a, f).numpy()[hit.numpy()],
                                   np.asarray(getattr(b, f))[hit.numpy()],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_light_sample_and_pdf_match_jax():
    _, js, ps, ro, rd, h, rs = _hits("cornell")
    hit = (h.inst_idx >= 0).numpy()
    p = (ro + rd * np.where(hit, h.t.numpy(), 1.0)[:, None]) \
        .astype(np.float32)
    r = [rs.uniform(size=len(p)).astype(np.float32) for _ in range(3)]
    a = pt.sample_light_source(ps, torch.from_numpy(p),
                               *(torch.from_numpy(x) for x in r))
    b = jt.sample_light_source(js, jnp.asarray(p),
                               *(jnp.asarray(x) for x in r))
    assert (a.pdf > 0).float().mean() > 0.5
    for f in a._fields:
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   np.asarray(getattr(b, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    t = torch.from_numpy(rs.uniform(0.5, 3.0, len(p)).astype(np.float32))
    pdf = pt.get_light_pdf(ps, h.tri_idx, h.inst_idx, t, torch.from_numpy(rd))
    pdf_j = jt.get_light_pdf(js, jnp.asarray(h.tri_idx.numpy()),
                             jnp.asarray(h.inst_idx.numpy()),
                             jnp.asarray(t.numpy()), jnp.asarray(rd))
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_j), rtol=1e-5,
                               atol=1e-6)
    assert (pdf > 0).any()


def test_sample_texture_matches_jax():
    """The level-0 quad table, uv in [-2, 3) (repeat wrap), every 4th lane
    without a texture (white): within an ulp of JAX's sample."""
    _, js, _, ps = _scenes("textured")
    rs = np.random.default_rng(9)
    uv = rs.uniform(-2, 3, (4096, 2)).astype(np.float32)
    idx = np.where(np.arange(4096) % 4 == 0, -1, 0).astype(np.int32)
    a = pt.sample_texture(ps.textures, torch.from_numpy(idx),
                          torch.from_numpy(uv)).numpy()
    b = np.asarray(jt.sample_texture(js.textures, jnp.asarray(idx),
                                     jnp.asarray(uv)))
    np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-7)
    assert (a[idx < 0] == 1.0).all()
    red, blue = a[:, 0] > 4 * a[:, 2], a[:, 2] > 4 * a[:, 0]
    assert red.mean() > 0.2 and blue.mean() > 0.2


# -- frames -------------------------------------------------------------------

TRACE = {"cornell": ("cornell", 16, 3, 2), "textured": ("textured", 16, 3, 1)}


@pytest.fixture(scope="module", params=sorted(TRACE))
def bvh_frames(request):
    """Per frame 1..2: (JAX col, JAX rays, port col, port rays)."""
    case, res, depth, spp = TRACE[request.param]
    jw, js, pw, ps = _scenes(case, res)
    cam = np.asarray(pw.camera(), np.float32)
    out = []
    for f in (1, 2):
        cj, rj = _jax_trace(js, jnp.asarray(cam), jnp.asarray(f, jnp.int32),
                            jnp.zeros(2, jnp.float32), width=res, height=res,
                            spp=spp, max_depth=depth, with_stats=True)
        cp, rp = pt.trace_pixels(ps, torch.from_numpy(cam), f, torch.zeros(2),
                                 res, res, spp, depth, with_stats=True)
        out.append((np.asarray(cj), float(rj), cp.numpy(), float(rp)))
    return request.param, out


@pytest.mark.parametrize("frame", [1, 2])
def test_trace_pixels_matches_jax(bvh_frames, frame):
    case, per_frame = bvh_frames
    a, rays_a, b, rays_b = per_frame[frame - 1]
    assert b.shape == a.shape and np.isfinite(b).all(), case
    assert b.mean() > 0.05, case
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    frac = (rel < 1e-3).mean()
    assert frac >= 0.95, f"{case}: {frac:.3%} lanes match"
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3), case
    assert abs(rays_a - rays_b) <= 0.02 * rays_a, case


def test_bvh_trace_matches_dense_trace():
    """The port's two backends on the same RNG streams: near-identical
    radiance (tests/test_dense.py's bounds for JAX's two backends)."""
    world = NativeWorld("cornell")
    world.update_camera(32, 32)
    scene = build_device_scene(world, device="cpu")
    tables = build_world_tables(world, "cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    a = pt.trace_pixels(scene, cam, 1, torch.zeros(2), 32, 32, 1, 5).numpy()
    b = trace_pixels_dense(tables, cam, 1, torch.zeros(2), 32, 32, 1,
                           5).numpy()
    assert np.isclose(a, b, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert abs(a.mean() - b.mean()) < 1e-4


def test_max_depth_zero_differs_between_backends():
    """At max_depth 0 the BVH loop runs no bounce: zero radiance and R rays
    a sample, as JAX `trace_pixels` gives. The dense loop (both packages)
    still runs one shadow-only bounce, so its frame is lit."""
    res = 8
    world, wt, tables = jax_and_port_tables("cornell", res)
    jw, js, _, ps = _scenes("cornell", res)
    cam = np.asarray(world.camera(), np.float32)
    col, rays = pt.trace_pixels(ps, torch.from_numpy(cam), 1, torch.zeros(2),
                                res, res, 2, 0, with_stats=True)
    assert float(col.abs().max()) == 0.0 and float(rays) == 2 * res * res
    cj, rj = _jax_trace(js, jnp.asarray(cam), jnp.asarray(1, jnp.int32),
                        jnp.zeros(2, jnp.float32), width=res, height=res,
                        spp=2, max_depth=0, with_stats=True)
    assert float(jnp.abs(cj).max()) == 0.0 and float(rj) == 2 * res * res
    dense = trace_pixels_dense(tables, torch.from_numpy(cam), 1,
                               torch.zeros(2), res, res, 1, 0)
    assert float(dense.mean()) > 0.01


# -- the dense path's sharding offsets ----------------------------------------

def test_dense_offsets_match_jax_and_rebuild_the_frame():
    """A row band (rows 4..7 of 16) with a sample slice (samples 1..2 of
    4) against JAX `trace_pixels_dense` with the same offsets; the four
    row bands at the defaults' sample range put the whole frame back
    together bit for bit, and so do the sample slices' weighted sum."""
    W = H = 16
    world, wt, tables = jax_and_port_tables("cornell", W)
    scene = jax_scene(world)
    cam = np.asarray(world.camera(), np.float32)
    camt, jit = torch.from_numpy(cam), torch.tensor([0.01, -0.02])
    kw = dict(row0=4, full_height=H, total_spp=4, sample0=1)
    a = trace_pixels_dense(tables, camt, 3, jit, W, 4, 2, 3, **kw).numpy()
    b = np.asarray(_jax_dense(wt, scene.textures, jnp.asarray(cam),
                              jnp.asarray(3, jnp.int32),
                              jnp.asarray(jit.numpy()), width=W, height=4,
                              spp=2, max_depth=3, **kw))
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    assert (rel < 1e-3).mean() >= 0.95
    assert abs(a.mean() - b.mean()) < 0.02 * b.mean()

    whole = trace_pixels_dense(tables, camt, 3, jit, W, H, 4, 3)
    bands = torch.cat([trace_pixels_dense(tables, camt, 3, jit, W, 4, 4, 3,
                                          row0=4 * k, full_height=H)
                       for k in range(4)])
    assert torch.equal(bands.view(torch.int32), whole.view(torch.int32))
    slices = [trace_pixels_dense(tables, camt, 3, jit, W, H, 1, 3,
                                 total_spp=4, sample0=k) for k in range(4)]
    np.testing.assert_allclose(sum(slices).numpy() / 4, whole.numpy(),
                               rtol=2e-5, atol=2e-5)


# -- dispatch -----------------------------------------------------------------

def test_choose_backend_table():
    assert choose_backend(36, "cuda") == "dense"
    assert choose_backend(257_136, "cuda") == "dense"
    assert choose_backend(257_136, torch.device("cuda", 0)) == "dense"
    assert choose_backend(36, "cpu") == "dense"
    assert choose_backend(DENSE_MAX_TRIS, "cpu") == "dense"
    assert choose_backend(DENSE_MAX_TRIS + 1, "cpu") == "bvh"
    assert choose_backend(257_136, torch.device("cpu")) == "bvh"
    with pytest.raises(ValueError, match="backend"):
        get_tracer("raster")


def test_get_tracer_runs_both_backends():
    world = NativeWorld("cornell")
    world.update_camera(8, 8)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    scenes = {"dense": (build_world_tables(world, "cpu"), None),
              "bvh": build_device_scene(world, device="cpu")}
    for backend, scene in scenes.items():
        col, rays = get_tracer(backend)(scene, cam, 1, torch.zeros(2), 8, 8,
                                        1, 2, with_stats=True, row0=0,
                                        full_height=8)
        assert col.shape == (64, 3) and np.isfinite(col.numpy()).all()
        assert float(rays) >= 64 and float(col.mean()) > 0.01, backend


def test_renderer_backend_follows_the_rule():
    r = Renderer("cornell", config=RenderConfig(width=8, height=8,
                                                max_depth=2), device="cpu")
    assert r.backend == "dense" and r.scene is None and r.tables is not None
