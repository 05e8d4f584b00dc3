"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip where no card
is present. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda

These hold every path of the port on the card at small frames: each
kernel against its plain version, the launch counts of every path, the
captured steps against the eager ones, the sharded steps, and the product
surface (recorder, checkpoint, bridge, farm, CLI). `python3 chip_smoke.py`
times each kernel alone at its main-path shapes (512^2 and 1080p) and
holds it to its plain version there.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import (bvh_shade, cuda_dense, cuda_fetch,
                                            cuda_jobs, cuda_present, cuda_scan,
                                            shade_rows, tune)
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (keys_plain,
                                                         lane_terms, pair_ok,
                                                         worklists_plain)
from webgpu_raytracer_tpu_torch.ops.dense import (T_MAX, closest_plain,
                                                  jobs_chunked_plain,
                                                  jobs_closest_plain,
                                                  jobs_stats_plain,
                                                  ray_stack, rows_plain,
                                                  scan_closest_plain,
                                                  scan_shadow_plain,
                                                  shadow_plain, worklist_mask)
from webgpu_raytracer_tpu_torch.ops.coherence import box6, coherence_sort
from webgpu_raytracer_tpu_torch.ops.dense_trace import (bounce_inputs,
                                                        bounce_rays,
                                                        trace_pixels_dense)
from webgpu_raytracer_tpu_torch.ops.fetch import (fetch_quad_plain,
                                                  fetch_rows_plain)
from webgpu_raytracer_tpu_torch.ops.gbuffer import render_gbuffer
from webgpu_raytracer_tpu_torch.ops.rng import init_rng
from webgpu_raytracer_tpu_torch.ops.v3 import V3
from webgpu_raytracer_tpu_torch.render.worldtris import (build_world_tables,
                                                         tri_pad)

from tests import torch_scenes
from tests.glb_fixture import skinned_strip_glb
from tests.torch_ties import cross_tile_tie

pytestmark = pytest.mark.cuda
RES = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _scene(name, dev):
    world = NativeWorld(name)
    world.update_camera(RES, RES)
    tables = build_world_tables(world, dev)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    lane = torch.arange(RES * RES, device=dev)
    u = ((lane % RES).float() + 0.5) / RES
    v = 1.0 - ((lane // RES).float() + 0.5) / RES
    rd = V3(*(cam[4 + k] + u * cam[8 + k] + v * cam[12 + k] - cam[k]
              for k in range(3)))
    ro = V3(*(cam[k].expand(RES * RES).contiguous() for k in range(3)))
    return tables, ro, rd


@pytest.mark.parametrize("scene", ["cornell", "mixed"])
def test_sweep_kernel_matches_plain(cuda, scene):
    tables, ro, rd = _scene(scene, cuda)
    R = RES * RES
    tmax = torch.where(torch.arange(R, device=cuda) % 3 == 0, 0.0, T_MAX)
    rays8 = ray_stack(ro, rd, tmax)
    # mixed has 35 tiles: its sweeps take the job-stream path.
    kernel = "job_sweep" if cuda_dense.multi_tile(tables) else "dense_sweep"
    assert kernel == ("job_sweep" if scene == "mixed" else "dense_sweep")
    before = kernels.launches[kernel]
    t, idx, rows = cuda_dense.closest_with_row(tables, rays8, R // 2)
    occ = cuda_dense.shadow(tables, rays8)
    assert kernels.launches[kernel] == before + 2
    t_p, idx_p = closest_plain(tables, rays8)
    assert torch.equal(idx, idx_p) and torch.equal(t, t_p)
    assert torch.equal(rows, rows_plain(tables.shade_table, idx_p[R // 2:]))
    assert torch.equal(occ, shadow_plain(tables, rays8))


def test_sweep_wrapper_rejects_bad_tables(cuda):
    """Tables the kernel would read out of bounds are refused unlaunched."""
    tables, ro, rd = _scene("cornell", cuda)
    rays8 = ray_stack(ro, rd, T_MAX)
    tw = tables.shade_table.shape[0]
    before = kernels.launches["dense_sweep"]
    with pytest.raises(ValueError, match="valid_count"):
        cuda_dense.closest_with_row(tables._replace(valid_count=tw + 1), rays8)
    with pytest.raises(ValueError, match="features"):
        cuda_dense.shadow(
            tables._replace(features=tables.features[:10].contiguous()), rays8)
    assert kernels.launches["dense_sweep"] == before


def _cut_tables(tables, valid):
    """The first `valid` triangles of `tables` as tables of their own,
    padded as the scene compiler pads (tri_pad)."""
    tw = tables.shade_table.shape[0]
    tw_new = tri_pad(valid)
    feats = tables.features.view(-1, 5, tw)[:, :, :tw_new]
    return tables._replace(
        features=feats.reshape(-1, 5 * tw_new).contiguous(),
        shade_table=tables.shade_table[:tw_new].contiguous(),
        valid_count=valid)


def _aimed_stack(tables, R, seed, tri=None):
    """A fused (8, 2R) stack: R rays from points of the scene's box aimed
    at random points of the tables' triangles (every 7th with a short
    t_max, every 5th inactive), or all at triangle `tri`, from in front of
    it; then R rays in random directions."""
    rs = np.random.default_rng(seed)
    st = tables.shade_table.cpu().numpy().astype(np.float64)
    box = tables.box.cpu().numpy().astype(np.float64)
    pick = (rs.integers(0, tables.valid_count, R) if tri is None
            else np.full(R, tri))
    u, v = rs.uniform(0.05, 0.9, (2, R))
    flip = u + v > 0.95
    u, v = np.where(flip, 0.95 - v, u), np.where(flip, 0.95 - u, v)
    target = st[pick, 0:3] + u[:, None] * st[pick, 3:6] \
        + v[:, None] * st[pick, 6:9]
    if tri is None:
        ro = rs.uniform(box[:3], box[3:], (R, 3))
    else:
        n = np.cross(st[tri, 3:6], st[tri, 6:9])
        ro = target + n / np.linalg.norm(n) + rs.normal(0, 0.05, (R, 3))
    rd = target - ro
    lane = np.arange(R)
    tmax = np.where(lane % 7 == 3, 0.5, T_MAX)
    tmax[lane % 5 == 1] = 0.0
    ro2 = rs.uniform(box[:3], box[3:], (R, 3))
    rd2 = rs.normal(size=(R, 3))
    stack = np.concatenate([
        np.concatenate([rd, ro, tmax[:, None], np.zeros((R, 1))], 1),
        np.concatenate([rd2, ro2, np.full((R, 1), T_MAX),
                        np.zeros((R, 1))], 1)]).T
    return torch.from_numpy(stack.astype(np.float32)).cuda().contiguous()


def _sweep_bit_equal(tables, rays8, R):
    """dense_sweep.cu equal to the plain versions bit for bit (t, idx, rows
    from lanes 0, R and 2R, occlusion), from two launches each; returns
    (idx, occlusion)."""
    before = kernels.launches["dense_sweep"]
    t_p, i_p = closest_plain(tables, rays8)
    occ_p = shadow_plain(tables, rays8)
    for row_from in (0, R, 2 * R):
        rows_p = rows_plain(tables.shade_table, i_p[row_from:])
        for _ in range(2):
            t, idx, rows = cuda_dense.full_sweep(tables, rays8, False,
                                                 row_from)
            assert torch.equal(_bits(t), _bits(t_p))
            assert torch.equal(idx, i_p)
            assert rows.shape == rows_p.shape
            assert torch.equal(_bits(rows), _bits(rows_p))
    for _ in range(2):
        assert torch.equal(cuda_dense.full_sweep(tables, rays8, True), occ_p)
    assert kernels.launches["dense_sweep"] == before + 8
    return i_p, occ_p


@pytest.mark.parametrize("valid", [1, 36, 127, 128, 129, 300])
def test_dense_sweep_bit_equal_by_triangle_count(cuda, valid):
    """One tile (rows staged once a block) up to 128 triangles, tile after
    tile above (rows from device memory), at 2R = 3,002 lanes: neither a
    multiple of the block nor of the rays a thread."""
    world = NativeWorld("mixed")
    tables = _cut_tables(build_world_tables(world, cuda), valid)
    R = 1501
    rays8 = _aimed_stack(tables, R, valid)
    idx, occ = _sweep_bit_equal(tables, rays8, R)
    assert int((idx[:R] >= 0).sum()) > R // 2 and int(idx.max()) < valid
    assert bool(occ.any()) and not bool(occ.all())


def test_dense_sweep_all_inactive(cuda):
    """Every lane inactive: t_max back, no hit, zero rows, no occlusion."""
    tables, _, _ = _scene("cornell", cuda)
    R = 1500
    rays8 = _aimed_stack(tables, R, 1)
    rays8[6] = 0.0
    idx, occ = _sweep_bit_equal(tables, rays8, R)
    assert bool((idx == -1).all()) and not bool(occ.any())


def test_dense_sweep_any_hit_all_occluded_by_the_first_triangle(cuda):
    """Every lane aims at a point inside triangle 0: each is occluded at
    the walk's first triangle (and leaves the walk there)."""
    tables, _, _ = _scene("cornell", cuda)
    R = 1500
    rays8 = _aimed_stack(tables, R, 2, tri=0)[:, :R].contiguous()
    rays8[6] = T_MAX
    _, occ = _sweep_bit_equal(tables, rays8, R // 2)
    assert bool(occ.all())


def test_dense_sweep_exact_tie_goes_to_the_lower_index(cuda):
    """The two most-hit triangles of cornell's first half copied over a
    later, little-hit triangle each: every lane that hits an original ties
    with its copy bit for bit, and the original (the lower index) wins;
    with the originals gone, the same lanes hit the copies at the same
    t."""
    tables, _, _ = _scene("cornell", cuda)
    R = 1500
    rays8 = _aimed_stack(tables, R, 3)
    _, idx0, _ = cuda_dense.full_sweep(tables, rays8, False)
    hist = torch.bincount(idx0[idx0 >= 0].long(),
                          minlength=tables.valid_count).cpu()
    order = torch.argsort(hist, descending=True).tolist()
    src = sorted([j for j in order if j < tables.valid_count // 2][:2])
    dst = [j for j in reversed(order) if j > src[1]][:2]
    src_t = torch.tensor(src, device=cuda, dtype=torch.int32)
    dst_t = torch.tensor(dst, device=cuda, dtype=torch.int32)
    tw = tables.shade_table.shape[0]
    feats = tables.features.clone().view(-1, 5, tw)
    feats[:, :, dst] = feats[:, :, src]
    shade = tables.shade_table.clone()
    shade[dst] = shade[src]
    tied = tables._replace(features=feats.view(-1, 5 * tw).contiguous(),
                           shade_table=shade)
    idx, _ = _sweep_bit_equal(tied, rays8, R)
    on_src = torch.isin(idx, src_t)
    assert int(on_src.sum()) >= 50 and not bool(torch.isin(idx, dst_t).any())
    gone = feats.clone()
    gone[:, :, src] = 0.0
    t_c, idx_c, _ = cuda_dense.full_sweep(
        tied._replace(features=gone.view(-1, 5 * tw).contiguous()), rays8,
        False)
    t_f, _, _ = cuda_dense.full_sweep(tied, rays8, False)
    assert bool(torch.isin(idx_c[on_src], dst_t).all())
    assert torch.equal(_bits(t_c[on_src]), _bits(t_f[on_src]))


def test_max_depth_zero_on_card(cuda):
    """max_depth=0 runs the last, shadow-only bounce alone: per frame a
    primary sweep, one light-row fetch and one shadow query, and the
    frame the plain versions give on the CPU."""
    world = NativeWorld("cornell")
    world.update_camera(32, 32)
    frames = []
    for dev in ("cpu", "cuda"):
        tables = build_world_tables(world, dev)
        cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
        kernels.reset_launches()
        frames.append(trace_pixels_dense(tables, cam, 1,
                                         torch.zeros(2, device=dev), 32, 32,
                                         1, 0).cpu())
        counts = dict(kernels.launches)
    assert counts == {"dense_sweep": 2, "shade_rows": 0, "fetch_rows": 1,
                      "fetch_quad": 0, "cluster_cull": 0, "job_sweep": 0,
                      "cluster_cull_keyed": 0, "scan_sweep": 0,
                      "bvh_closest": 0, "bvh_shadow": 0, "bvh_shade": 0,
                      "bvh_walk": 0, "all_reduce": 0, "present": 0}
    assert frames[1].mean() > 0.01
    close = torch.isclose(frames[1], frames[0], rtol=1e-3, atol=1e-5).all(1)
    assert close.float().mean() >= 0.95


# Textured scenes of the shade kernel's textured instantiation: GLB maker
# and whether a fifth layer is added (so level 1 is level 0).
SHADE_TEXTURED = {"textured": (torch_scenes.textured_quad_glb, False),
                  "formats": (torch_scenes.formats_scene_glb, False),
                  "five_layers": (torch_scenes.formats_scene_glb, True),
                  "textured_light": (torch_scenes.textured_light_glb, False)}


@pytest.mark.parametrize("scene,depth", [
    ("cornell", 0), ("cornell", 4), ("textured", 0), ("textured", 4),
    ("formats", 0), ("five_layers", 0), ("textured_light", 0)])
def test_shade_kernel_matches_plain(cuda, scene, depth):
    """Both instantiations against shade_step: cornell's primary hits shaded
    as bounce `depth`, a textured scene's inputs advanced `depth` bounces
    through the kernels. rng words equal, the ray stack equal to the
    kernel's own rows, >= 99.5% of lanes within rtol 1e-4 and flags equal
    on as many."""
    if scene == "cornell":  # the primary hits, shaded as bounce `depth`
        tables, ro, rd = _scene("cornell", cuda)
        textures = None
        R = RES * RES
        _, idx, rowT = cuda_dense.closest_with_row(tables, ray_stack(ro, rd,
                                                                     T_MAX))
        one, zero = torch.ones(R, device=cuda), torch.zeros(R, device=cuda)
        state = torch.stack([one, *ro, *rd, one, one, one, zero, zero, zero,
                             zero, one, zero, zero, zero, zero, one])
        rng = init_rng(torch.arange(R, device=cuda), 1)
    else:
        glb, fifth = SHADE_TEXTURED[scene]
        tables, cam, textures = torch_scenes.textured_scene(glb(), RES, RES,
                                                          cuda, fifth=fifth)
        assert (textures[1] is textures[0]) == fifth
        state, rng, rowT, idx = bounce_inputs(tables, cam, RES, RES, depth,
                                              8, textures)
    kw = dict(textures=textures)
    args = (state, rng, rowT, idx, tables.light_rows, depth,
            tables.light_count, 8)
    before = kernels.launches["shade_rows"]
    out, rng_k, rays8 = shade_rows.shade(*args, **kw)
    assert kernels.launches["shade_rows"] == before + 1
    out_p, rng_p = shade_rows.shade_step(*args, **kw)
    assert torch.equal(rng_k, rng_p)
    assert torch.equal(rays8, shade_rows.next_rays(out))
    assert torch.isfinite(out).all()
    close = torch.isclose(out, out_p, rtol=1e-4, atol=1e-5).all(0)
    assert close.float().mean() >= 0.995
    flag_rows = list(shade_rows.FLAG_ROWS)
    flags = (out[flag_rows] == out_p[flag_rows]).all(0)
    assert flags.float().mean() >= 0.995


# (depth, frames, res, expected, tol) of tests/test_golden.py's GOLDEN,
# which this card-only file cannot import: that module imports JAX, and a
# host that runs the port on its card need not have JAX.
GOLDEN = {
    "cornell": (5, 8, 32, 0.2597, 0.03),
    "viewer": (4, 8, 32, 0.5219, 0.05),
    "mixed": (5, 8, 32, 0.2216, 0.025),
    "special": (5, 8, 32, 0.1355, 0.02),
    "mesh": (4, 8, 32, 0.1796, 0.022),
}


@pytest.mark.parametrize("scene_name", sorted(GOLDEN))
def test_golden_mean_radiance_on_card(cuda, scene_name):
    """The golden bounds, through the kernels; the multi-tile presets walk
    many 128-triangle tiles."""
    depth, frames, res, expected, tol = GOLDEN[scene_name]
    world = NativeWorld(scene_name)
    world.update_camera(res, res)
    tables = build_world_tables(world, cuda)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(cuda)
    jitter = torch.zeros(2, device=cuda)
    mean = np.mean([
        trace_pixels_dense(tables, cam, f, jitter, res, res, 1,
                           depth).mean().item()
        for f in range(1, frames + 1)])
    assert abs(mean - expected) < tol, (scene_name, mean, expected, tol)


def test_renderer_on_card_counts_launches(cuda):
    r = Renderer("cornell",
                 config=RenderConfig(width=RES, height=RES, max_depth=5),
                 device="cuda")
    for _ in range(2):
        r.render_frame()
        img = r.present()
    assert img.shape == (RES, RES, 3) and np.isfinite(r.radiance()).all()
    assert r.launches == {"dense_sweep": 2 * 6, "shade_rows": 2 * 5,
                          "fetch_rows": 0, "fetch_quad": 0,
                          "cluster_cull": 0, "job_sweep": 0,
                          "cluster_cull_keyed": 0, "scan_sweep": 0,
                          "bvh_closest": 0, "bvh_shadow": 0, "bvh_shade": 0,
                          "bvh_walk": 0, "all_reduce": 0,
                          "present": 2 * cuda_present.LAUNCHES}


@pytest.mark.parametrize("n,k", [(1, 40), (40, 40), (1408, 40), (300, 3)])
def test_fetch_rows_kernel_matches_plain(cuda, n, k):
    """Bit-equal to table[clip(idx)].T, odd R, indices out of range."""
    rs = np.random.default_rng(n + k)
    table = torch.from_numpy(rs.normal(size=(n, k)).astype(np.float32))
    table[0, 0] = -0.0
    idx = np.concatenate([[-1, n, -7, n + 5, 0, n - 1],
                          rs.integers(-2, n + 2, 995)]).astype(np.int32)
    table, idx = table.to(cuda), torch.from_numpy(idx).to(cuda)
    before = kernels.launches["fetch_rows"]
    out = cuda_fetch.fetch_rows_t(table, idx)
    assert kernels.launches["fetch_rows"] == before + 1
    want = fetch_rows_plain(table, idx)
    assert out.shape == (k, 1001)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [1, 16384])
def test_fetch_quad_kernel_matches_plain(cuda, n):
    rs = np.random.default_rng(n)
    flat = rs.integers(0, 1 << 24, size=(n, 4)).astype(np.int32)
    flat[0] = [0, (1 << 24) - 1, 0xFF0000, 0x0000FF]
    rows = np.concatenate([[-1, n, 0, n - 1],
                           rs.integers(-3, n + 3, 997)]).astype(np.int32)
    flat, rows = torch.from_numpy(flat).to(cuda), torch.from_numpy(rows).to(
        cuda)
    before = kernels.launches["fetch_quad"]
    out = cuda_fetch.fetch_quad(flat, rows)
    assert kernels.launches["fetch_quad"] == before + 1
    assert torch.equal(out, fetch_quad_plain(flat, rows))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("r", [1, 3, 5, 4097, 2_073_600])
def test_fetch_quad_kernel_by_lane_count(cuda, r, offset):
    """Every lane count from one to a 1080p frame's, and a `rows` view that
    starts one element past a 16-byte boundary, bit-equal to the plain
    version, at the mip's 16,384 rows."""
    rs = np.random.default_rng(r + offset)
    n = 16384
    flat = torch.from_numpy(rs.integers(0, 1 << 24, size=(n, 4)).astype(
        np.int32)).to(cuda)
    base = torch.from_numpy(rs.integers(-3, n + 3, r + offset).astype(
        np.int32)).to(cuda)
    rows = base[offset:]
    assert (rows.data_ptr() % 16 != 0) == bool(offset)
    before = kernels.launches["fetch_quad"]
    out = cuda_fetch.fetch_quad(flat, rows)
    assert kernels.launches["fetch_quad"] == before + 1
    assert torch.equal(out, fetch_quad_plain(flat, rows))


def test_fetch_wrappers_reject_bad_inputs(cuda):
    table = torch.zeros((8, 40), device=cuda)
    flat = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    idx = torch.zeros(5, dtype=torch.int32, device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(TypeError, match="idx"):
        cuda_fetch.fetch_rows_t(table, idx.long())
    with pytest.raises(ValueError, match="idx"):
        cuda_fetch.fetch_rows_t(table, idx.cpu())
    with pytest.raises(ValueError, match="no rows"):
        cuda_fetch.fetch_rows_t(table[:0], idx)
    with pytest.raises(ValueError, match="flat"):
        cuda_fetch.fetch_quad(flat[:, :3].contiguous(), idx)
    with pytest.raises(ValueError, match="aligned"):
        cuda_fetch.fetch_quad(flat.view(-1)[1:29].view(7, 4), idx)
    assert kernels.launches == before


def test_textured_renderer_on_card_counts_launches(cuda):
    """The textured quad (base-colour texture only, untextured lights):
    per frame of depth 5, seeded from the G-buffer: 6 sweeps (G-buffer, 5
    bounces), 5 shades (the textured instantiation samples the texels), 1
    row fetch (the seed rows) and 1 quad fetch (the G-buffer's base
    colour)."""
    r = Renderer("viewer",
                 config=RenderConfig(width=RES, height=RES, max_depth=5),
                 glb_data=torch_scenes.textured_quad_glb(), device="cuda")
    for _ in range(2):
        r.render_frame(use_gbuffer=True)
        img = r.present()
    assert img.shape == (RES, RES, 3) and np.isfinite(r.radiance()).all()
    assert r.launches == {"dense_sweep": 2 * 6, "shade_rows": 2 * 5,
                          "fetch_rows": 2 * 1, "fetch_quad": 2 * 1,
                          "cluster_cull": 0, "job_sweep": 0,
                          "cluster_cull_keyed": 0, "scan_sweep": 0,
                          "bvh_closest": 0, "bvh_shadow": 0, "bvh_shade": 0,
                          "bvh_walk": 0, "all_reduce": 0,
                          "present": 2 * cuda_present.LAUNCHES}


def _launched():
    """The launch counts since the last reset that are not zero."""
    return {k: v for k, v in kernels.launches.items() if v}


def test_textured_traced_frame_on_card_counts_launches(cuda):
    """The textured quad traced at 32^2 depth 5: 6 sweeps and 5 shades
    (the textured instantiation samples the texels itself), no row or quad
    fetch; the frame close to the plain versions' on the CPU (>= 95% of
    lanes at rel < 1e-3)."""
    frames = []
    for dev in ("cpu", "cuda"):
        tables, cam, textures = torch_scenes.textured_scene(
            torch_scenes.textured_quad_glb(), 32, 32, dev)
        kernels.reset_launches()
        frames.append(trace_pixels_dense(
            tables, cam, 1, torch.zeros(2, device=dev), 32, 32, 1, 5,
            textures=textures).cpu())
    assert _launched() == {"dense_sweep": 6, "shade_rows": 5}
    assert frames[1].mean() > 0.05
    close = torch.isclose(frames[1], frames[0], rtol=1e-3, atol=1e-5).all(1)
    assert close.float().mean() >= 0.95


def test_formats_scene_bit_equal_to_its_png_twin_on_card(cuda):
    """The texture formats scene (a 4:2:0 JPEG, a progressive JPEG, a
    16-bit Adam7 PNG and a 4-bit palette PNG in the four slots) through
    `Renderer` at 64^2 depth 4, two frames traced and then two seeded from
    the G-buffer: every accumulator bit-equal to its twin's (the port's
    decodes written as 8-bit PNGs). Four layers, a (1024^2, 128^2)
    pyramid; a frame launches 5 sweeps and 4 shades, seeded also one
    seed-row fetch and two quad fetches (base colour, normal map)."""
    cfg = RenderConfig(width=RES, height=RES, max_depth=4)
    rf, twin = (Renderer("viewer", config=cfg, device="cuda",
                         glb_data=torch_scenes.formats_scene_glb(twin=t))
                for t in (False, True))
    assert rf.textures[0].shape == (4, 1024, 1024)
    assert rf.textures[1].shape == (4, 128, 128)
    assert rf.tables.tex_slots == (True, True, True, True)
    for seeded, fetches in ((False, {}),
                            (True, {"fetch_rows": 2, "fetch_quad": 4})):
        for r in (rf, twin):
            r.launches = dict.fromkeys(r.launches, 0)
        for _ in range(2):
            a = rf.render_frame(use_gbuffer=seeded).clone()
            b = twin.render_frame(use_gbuffer=seeded).clone()
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        want = dict.fromkeys(rf.launches, 0)
        want.update(dense_sweep=2 * 5, shade_rows=2 * 4, **fetches)
        assert rf.launches == want and twin.launches == want
    assert float(a[:, :3].mean()) > 0.0


def test_seeded_frames_bit_equal_to_traced_on_card(cuda):
    """cornell at 64^2 depth 4, frames 1 and 2 at jitter 0: seeded from the
    G-buffer (its sweep, then one seed-row fetch) bit-equal to traced (the
    primary sweep); each pair launches 10 sweeps, 8 shades, 1 row fetch."""
    world = NativeWorld("cornell")
    world.update_camera(RES, RES)
    tables = build_world_tables(world, cuda)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(cuda)
    jitter = torch.zeros(2, device=cuda)
    for f in (1, 2):
        kernels.reset_launches()
        traced = trace_pixels_dense(tables, cam, f, jitter, RES, RES, 1, 4)
        gb = render_gbuffer(tables, None, cam, RES, RES, jitter=jitter)
        seeded = trace_pixels_dense(tables, cam, f, jitter, RES, RES, 1, 4,
                                    seed_wt_idx=gb.wt_idx.reshape(-1))
        assert _launched() == {"dense_sweep": 10, "shade_rows": 8,
                               "fetch_rows": 1}
        assert torch.equal(traced.view(torch.int32), seeded.view(torch.int32))
        assert float(traced.mean()) > 0.05


# --- the job-stream path (multi-tile scenes) ---------------------------------


@pytest.fixture(scope="module")
def bounce_stacks():
    """name -> (tables, the fused (8, 2R) ray stack of bounce 1 at RES^2,
    R), advanced through the kernels: mixed (35 tiles) and spheres (2,009
    tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    out = {}
    for name in ("mixed", "spheres"):
        world = NativeWorld(name)
        world.update_camera(RES, RES)
        tables = build_world_tables(world, "cuda")
        cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
        out[name] = (tables, bounce_rays(tables, cam, RES, RES, 1, 8),
                     RES * RES)
    return out


def _sort_and_cull(tables, rays8, R, g=128):
    """The fused sweep's sort (segments split at R) and the cull kernel."""
    rays_s, perm = coherence_sort(rays8, tables.box, g, R)
    order, counts = cuda_jobs.worklists(tables.spheres, rays_s, g,
                                        tables.box)
    return rays_s, perm, order, counts


@pytest.mark.parametrize("scene", ["mixed", "spheres"])
def test_cull_kernel_matches_plain(cuda, bounce_stacks, scene):
    tables, rays8, R = bounce_stacks[scene]
    g = 128
    rays_s, perm, order, counts = _sort_and_cull(tables, rays8, R)
    assert kernels.launches["cluster_cull"] > 0
    order_p, counts_p = worklists_plain(tables.spheres, rays_s, g,
                                        box6(tables.spheres))
    assert torch.equal(counts, counts_p)
    ct = tables.spheres.shape[0]
    assert torch.equal(worklist_mask(order, counts, ct),
                       worklist_mask(order_p, counts_p, ct))
    pos = torch.arange(ct, device=cuda)[None, :] < counts[:, None]
    assert torch.equal(torch.where(pos, order, -1),
                       torch.where(pos, order_p, -1))  # ascending ids
    assert 0 < int(counts.max()) < ct


@pytest.mark.parametrize("scene", ["mixed", "spheres"])
def test_job_kernel_bit_equal_to_full_sweep(cuda, bounce_stacks, scene):
    """t, idx and rows bit-equal to dense_sweep.cu walking every tile;
    occlusion equal to its any-hit mode; also against the plain job
    sweep."""
    tables, rays8, R = bounce_stacks[scene]
    before = dict(kernels.launches)
    t, idx, rows = cuda_dense.closest_with_row(tables, rays8, R)
    occ = cuda_dense.shadow(tables, rays8)
    assert kernels.launches["job_sweep"] == before["job_sweep"] + 2
    assert kernels.launches["cluster_cull"] == before["cluster_cull"] + 2
    assert kernels.launches["dense_sweep"] == before["dense_sweep"]
    t_f, idx_f, rows_f = cuda_dense.full_sweep(tables, rays8, False, R)
    occ_f = cuda_dense.full_sweep(tables, rays8, True)
    assert torch.equal(idx, idx_f)
    assert torch.equal(t.view(torch.int32), t_f.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), rows_f.view(torch.int32))
    assert torch.equal(occ, occ_f)
    hits = float((idx >= 0).float().mean())
    assert 0.05 < hits < 1.0, hits

    rays_s, perm, order, counts = _sort_and_cull(tables, rays8, R)
    t_s, i_s = jobs_closest_plain(tables, rays_s, order, counts, 128)
    keep = perm.long() < 2 * R
    assert torch.equal(i_s[keep], idx[perm.long()[keep]])
    assert torch.equal(t_s[keep], t[perm.long()[keep]])


def test_renderer_spheres_on_card_counts_launches(cuda):
    """spheres (257k tris) through the job path: per frame of depth 3, one
    primary and three fused sweeps, each a cull and a job sweep."""
    r = Renderer("spheres",
                 config=RenderConfig(width=RES, height=RES, max_depth=3),
                 device="cuda")
    for _ in range(2):
        r.render_frame()
        img = r.present()
    assert img.shape == (RES, RES, 3) and np.isfinite(r.radiance()).all()
    assert r.launches == {"dense_sweep": 0, "cluster_cull": 2 * 4,
                          "job_sweep": 2 * 4, "shade_rows": 2 * 3,
                          "fetch_rows": 0, "fetch_quad": 0,
                          "cluster_cull_keyed": 0, "scan_sweep": 0,
                          "bvh_closest": 0, "bvh_shadow": 0, "bvh_shade": 0,
                          "bvh_walk": 0, "all_reduce": 0,
                          "present": 2 * cuda_present.LAUNCHES}


# --- the scan path (narrow="scan") -------------------------------------------


@pytest.mark.parametrize("m", [512, 1024])
@pytest.mark.parametrize("scene", ["mixed", "spheres"])
def test_keyed_cull_kernel_matches_plain(cuda, bounce_stacks, scene, m):
    """Survivors equal and keys within 2 ulp (bit-equal where both take
    the correctly rounded root and quotient) of the plain keyed cull."""
    tables, rays8, R = bounce_stacks[scene]
    rays_s, _ = coherence_sort(rays8, tables.box, m, R)
    before = kernels.launches["cluster_cull_keyed"]
    keys = cuda_scan.cluster_keys(tables.spheres, rays_s, m, tables.box)
    assert kernels.launches["cluster_cull_keyed"] == before + 1
    keys_p = keys_plain(tables.spheres, rays_s, m, box6(tables.spheres))
    assert torch.equal(keys < 3e38, keys_p < 3e38)
    ulps = (keys.view(torch.int32).long()
            - keys_p.view(torch.int32).long()).abs().max()
    assert int(ulps) <= 2, int(ulps)
    assert 0 < int((keys < 3e38).sum(1).max()) <= tables.spheres.shape[0]


def _assert_culls_equal_plain(spheres, rays_s, g):
    """Both cull kernels on a sorted stack: worklists (counts, survivors in
    ascending id) and keys bit-equal to the plain versions, and to
    themselves from a second launch."""
    ct = spheres.shape[0]
    box = box6(spheres)
    before = dict(kernels.launches)
    order, counts = cuda_jobs.worklists(spheres, rays_s, g, box)
    keys = cuda_scan.cluster_keys(spheres, rays_s, g, box)
    assert kernels.launches["cluster_cull"] == before["cluster_cull"] + 1
    assert kernels.launches["cluster_cull_keyed"] == \
        before["cluster_cull_keyed"] + 1
    order_p, counts_p = worklists_plain(spheres, rays_s, g, box)
    keys_p = keys_plain(spheres, rays_s, g, box)
    pos = torch.arange(ct, device=rays_s.device)[None, :] < counts_p[:, None]
    assert torch.equal(counts, counts_p)
    assert torch.equal(torch.where(pos, order, -1),
                       torch.where(pos, order_p, -1))
    assert torch.equal(_bits(keys), _bits(keys_p))
    order2, counts2 = cuda_jobs.worklists(spheres, rays_s, g, box)
    assert torch.equal(counts2, counts)
    assert torch.equal(torch.where(pos, order2, -1),
                       torch.where(pos, order, -1))
    assert torch.equal(_bits(cuda_scan.cluster_keys(spheres, rays_s, g, box)),
                       _bits(keys))
    return counts, keys


@pytest.mark.parametrize("g", [32, 128, 256, 1024])
@pytest.mark.parametrize("ct", [1, 31, 33, 2009])
def test_cull_kernels_bit_equal_to_plain(cuda, bounce_stacks, ct, g):
    """Every lanes-per-thread and warps-per-block layout of the kernels
    (g), at cluster counts around their 32-cluster blocks' edge (the first
    ct spheres of the spheres scene, whose box then is theirs)."""
    tables, rays8, R = bounce_stacks["spheres"]
    spheres = tables.spheres[:ct].contiguous()
    rays_s, _ = coherence_sort(rays8, box6(spheres), g, R)
    counts, keys = _assert_culls_equal_plain(spheres, rays_s, g)
    # The unkeyed test's ends are nudged outward, the keyed test's are not.
    assert int(counts.sum()) >= int((keys < 3e38).sum())
    assert ct == 1 or int((keys < 3e38).sum()) > 0


@pytest.mark.parametrize("g", [128, 1024])
def test_cull_kernels_dead_lanes_and_padding(cuda, bounce_stacks, g):
    """A group whose lanes are half dead, out of the sort's order; a stack
    that is all dead; a sphere table that is all padding."""
    tables, rays8, R = bounce_stacks["spheres"]
    spheres = tables.spheres
    ct = spheres.shape[0]
    rays_s, _ = coherence_sort(rays8, tables.box, g, R)
    full, _ = _assert_culls_equal_plain(spheres, rays_s, g)
    assert int(full[0]) > 0

    half = rays_s.clone()
    half[6, 0:g:2] = 0.0
    half[6, g // 2:g] = 0.0
    counts, _ = _assert_culls_equal_plain(spheres, half, g)
    assert 0 < int(counts[0]) <= int(full[0])

    dead = rays_s.clone()
    dead[6] = 0.0
    counts, keys = _assert_culls_equal_plain(spheres, dead, g)
    assert int(counts.sum()) == 0 and bool((keys == 3e38).all())

    padding = spheres.clone()
    padding[:, 3] = -1.0
    counts, keys = _assert_culls_equal_plain(padding, rays_s, g)
    assert int(counts.sum()) == 0 and bool((keys == 3e38).all())
    assert keys.shape == (rays_s.shape[1] // g, ct)


@pytest.mark.parametrize("cull", ["exact", "cone"])
@pytest.mark.parametrize("scene", ["mixed", "spheres"])
def test_scan_kernel_bit_equal_to_full_sweep(cuda, bounce_stacks, scene,
                                             cull):
    """t, idx and rows bit-equal to dense_sweep.cu walking every tile and
    to the job path; occlusion equal; outputs and per-tile stats equal to
    the plain scan's."""
    tables, rays8, R = bounce_stacks[scene]
    m = 1024
    before = dict(kernels.launches)
    t, idx, rows = cuda_scan.closest_with_row(tables, rays8, R, cull=cull)
    occ = cuda_scan.shadow(tables, rays8, cull=cull)
    n_cull = 2 if cull == "exact" else 0
    assert kernels.launches["scan_sweep"] == before["scan_sweep"] + 2
    assert kernels.launches["cluster_cull_keyed"] == \
        before["cluster_cull_keyed"] + n_cull
    for k in ("dense_sweep", "job_sweep", "cluster_cull"):
        assert kernels.launches[k] == before[k]
    t_f, idx_f, rows_f = cuda_dense.full_sweep(tables, rays8, False, R)
    occ_f = cuda_dense.full_sweep(tables, rays8, True)
    assert torch.equal(idx, idx_f)
    assert torch.equal(t.view(torch.int32), t_f.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), rows_f.view(torch.int32))
    assert torch.equal(occ, occ_f)
    t_j, idx_j, rows_j = cuda_dense.closest_with_row(tables, rays8, R)
    assert torch.equal(idx, idx_j)
    assert torch.equal(t.view(torch.int32), t_j.view(torch.int32))
    assert torch.equal(rows.view(torch.int32), rows_j.view(torch.int32))

    # One sorted stack and its worklists through the kernel and the plain
    # version, both modes: outputs and per-tile stats.
    rays_s, perm = coherence_sort(rays8, tables.box, m, R)
    lists = cuda_scan.worklists_keyed(tables.spheres, rays_s, m, tables.box,
                                      cull)
    t_k, idx_k, _, stats = cuda_scan.scan_sweep(
        tables, rays_s, perm, *lists, m, 2 * R, False, R, with_stats=True)
    occ_k, stats_any = cuda_scan.scan_sweep(
        tables, rays_s, perm, *lists, m, 2 * R, True, with_stats=True)
    assert torch.equal(idx_k, idx_f) and torch.equal(occ_k, occ_f)
    t_s, i_s, stats_p = scan_closest_plain(tables, rays_s, *lists, m,
                                           with_stats=True)
    occ_s, stats_any_p = scan_shadow_plain(tables, rays_s, *lists, m,
                                           with_stats=True)
    keep = perm.long() < 2 * R
    assert torch.equal(i_s[keep], idx_k[perm.long()[keep]])
    assert torch.equal(t_s[keep], t_k[perm.long()[keep]])
    assert torch.equal(occ_s[keep], occ_k[perm.long()[keep]])
    assert torch.equal(stats.cpu(), stats_p)
    assert torch.equal(stats_any.cpu(), stats_any_p)
    assert int(stats[:, 1].sum()) > 0


@pytest.mark.parametrize("scene", ["viewer", "mixed"])
def test_scan_frames_bit_equal_to_job_frames(cuda, scene):
    world = NativeWorld(scene)
    world.update_camera(RES, RES)
    tables = build_world_tables(world, "cuda")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
    jit = torch.zeros(2, device=cuda)
    for f in (1, 2):
        a = trace_pixels_dense(tables, cam, f, jit, RES, RES, 1, 4,
                               narrow="scan")
        b = trace_pixels_dense(tables, cam, f, jit, RES, RES, 1, 4)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.isfinite(a).all() and float(a.mean()) > 0


def test_renderer_spheres_scan_on_card_counts_launches(cuda):
    """spheres through `narrow="scan"`: per frame of depth 3, one primary
    and three fused sweeps, each a keyed cull and a scan sweep; the
    accumulator equals the default Renderer's bit for bit."""
    cfg = dict(width=RES, height=RES, max_depth=3)
    r = Renderer("spheres", config=RenderConfig(**cfg), device="cuda",
                 narrow="scan")
    ref = Renderer("spheres", config=RenderConfig(**cfg), device="cuda")
    for _ in range(2):
        r.render_frame()
        ref.render_frame()
        img = r.present()
    assert img.shape == (RES, RES, 3) and np.isfinite(r.radiance()).all()
    assert torch.equal(r.accum.view(torch.int32),
                       ref.accum.view(torch.int32))
    assert r.launches == {"dense_sweep": 0, "cluster_cull": 0,
                          "job_sweep": 0, "cluster_cull_keyed": 2 * 4,
                          "scan_sweep": 2 * 4, "shade_rows": 2 * 3,
                          "fetch_rows": 0, "fetch_quad": 0,
                          "bvh_closest": 0, "bvh_shadow": 0, "bvh_shade": 0,
                          "bvh_walk": 0, "all_reduce": 0,
                          "present": 2 * cuda_present.LAUNCHES}


# --- the cooperative walk behind the queue of touching lanes -----------------


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _groups(rays_s, order, counts, sel, g):
    """The sorted stack, worklists and counts of the groups `sel` alone."""
    lanes = (sel[:, None] * g + torch.arange(g, device=sel.device)).flatten()
    return rays_s[:, lanes], order[sel], counts[sel]


def _hold_job_stats(tables, rays_s, order, counts, g, any_hit, stats,
                    t_end):
    """A group walked in one job counts what the plain one walk counts. A
    split group's chunks prune one another as they finish, so its pairs
    lie between the pairs its lanes' final segments (up to t_end) touch
    and those of its chunks each walked from t_max (and so its tiles, up to
    those). The chunk column is ceil(count / L) for every group."""
    L = tune.JOB_CHUNK
    stats = stats.cpu()
    c = counts.cpu()
    assert torch.equal(stats[:, 2], c)
    assert torch.equal(stats[:, 3], (c + L - 1) // L)
    whole = torch.nonzero(counts <= L).flatten()
    split = torch.nonzero(counts > L).flatten()
    if whole.numel():
        sub = _groups(rays_s, order, counts, whole, g)
        assert torch.equal(stats[whole.cpu()],
                           jobs_stats_plain(tables, *sub, g, any_hit, L))
    if split.numel():
        sub = _groups(rays_s, order, counts, split, g)
        apart = jobs_chunked_plain(tables, *sub, g, any_hit, L,
                                   from_t_max=True)[3]
        ct = tables.spheres.shape[0]
        listed = worklist_mask(sub[1], sub[2], ct).repeat_interleave(g, 0).T
        lanes = (split[:, None] * g
                 + torch.arange(g, device=split.device)).flatten()
        needed = (pair_ok(sub[0], lane_terms(sub[0], tables.box)[0],
                          t_end[lanes], tables.spheres)
                  & listed).sum(0).view(-1, g).sum(1).int().cpu()
        mine = stats[split.cpu()]
        assert (needed <= mine[:, 1]).all()
        assert (mine[:, 1] <= apart[:, 1]).all()
        assert (mine[:, 0] <= apart[:, 0]).all()
    return int(split.numel())


def _narrow_kernels_agree(tables, rays8, kernel):
    """One narrow-phase kernel (`"jobs"` at g = 128, `"scan"` at m = 1,024)
    on a whole stack: t, idx, rows and occlusion bit-equal to
    `dense_sweep.cu` walking every tile and to the plain versions, the same
    from a second launch (the queue's order varies, and a split worklist's
    chunks finish in any order), stats equal to the plain count (the job
    sweep's: for a worklist walked in one chunk; `_hold_job_stats`).
    Returns (idx, stats, stats_any, block size, split groups)."""
    R = rays8.shape[1]
    t_f, idx_f, rows_f = cuda_dense.full_sweep(tables, rays8, False)
    occ_f = cuda_dense.full_sweep(tables, rays8, True)
    t_p, idx_p = closest_plain(tables, rays8)
    assert torch.equal(idx_f, idx_p) and torch.equal(_bits(t_f), _bits(t_p))
    assert torch.equal(occ_f, shadow_plain(tables, rays8))
    name = "job_sweep" if kernel == "jobs" else "scan_sweep"
    before = kernels.launches[name]
    if kernel == "jobs":
        b = 128
        rays_s, perm = coherence_sort(rays8, tables.box, b, 0)
        lists = cuda_jobs.worklists(tables.spheres, rays_s, b, tables.box)

        def sweep(any_hit, stats=False):
            return cuda_jobs.job_sweep(tables, rays_s, perm, *lists, b, R,
                                       any_hit, with_stats=stats)

        t_s, i_s = jobs_closest_plain(tables, rays_s, *lists, b)
    else:
        b = 1024
        rays_s, perm = coherence_sort(rays8, tables.box, b, 0)
        lists = cuda_scan.worklists_keyed(tables.spheres, rays_s, b,
                                          tables.box)

        def sweep(any_hit, stats=False):
            return cuda_scan.scan_sweep(tables, rays_s, perm, *lists, b, R,
                                        any_hit, with_stats=stats)

        t_s, i_s, st = scan_closest_plain(tables, rays_s, *lists, b,
                                          with_stats=True)
        plain_stats = [st, scan_shadow_plain(tables, rays_s, *lists, b,
                                             with_stats=True)[1]]
    t, idx, rows, stats = sweep(False, True)
    occ, stats_any = sweep(True, True)
    assert kernels.launches[name] == before + 2
    assert torch.equal(idx, idx_f) and torch.equal(_bits(t), _bits(t_f))
    assert torch.equal(_bits(rows), _bits(rows_f))
    assert torch.equal(occ, occ_f)
    for a, b2 in zip(sweep(False), (t, idx, rows)):
        assert torch.equal(_bits(a), _bits(b2))
    assert torch.equal(sweep(True), occ)
    keep = perm.long() < R
    assert torch.equal(i_s[keep], idx[perm.long()[keep]])
    assert torch.equal(_bits(t_s[keep]), _bits(t[perm.long()[keep]]))
    split = 0
    if kernel == "jobs":
        live = rays_s[6] > 0.0
        lane = perm.long().clamp(max=R - 1)
        t_end = torch.where(live, t_s, 0.0)
        split = _hold_job_stats(tables, rays_s, *lists, b, False, stats,
                                t_end)
        t_end = torch.where(live & ~occ[lane], rays_s[6], 0.0)
        _hold_job_stats(tables, rays_s, *lists, b, True, stats_any, t_end)
    else:
        assert torch.equal(stats.cpu(), plain_stats[0])
        assert torch.equal(stats_any.cpu(), plain_stats[1])
    return idx, stats, stats_any, b, split


def _pairs_and_tiles(stats, kernel):
    """(pairs walked, tiles walked) per block, from either kernel's stats."""
    return (stats[:, 1], stats[:, 0]) if kernel == "jobs" \
        else (stats[:, 3], stats[:, 1])


@pytest.mark.parametrize("kernel", ["jobs", "scan"])
def test_narrow_kernels_in_tile_tie_goes_to_the_lowest_index(
        cuda, bounce_stacks, kernel):
    """The eight most-hit triangles of mixed get a copy inside their own
    tile, alternately one index up (the same thread of the cooperative
    walk, or its neighbour) and 32 up (another thread): every lane that hit
    an original ties with its copy bit for bit, and the original wins."""
    tables, rays8, _ = bounce_stacks["mixed"]
    _, idx0, _ = cuda_dense.full_sweep(tables, rays8, False)
    hist = torch.bincount(idx0[idx0 >= 0].long(),
                          minlength=tables.valid_count).cpu()
    pairs, used = [], set()
    for j in torch.argsort(hist, descending=True).tolist():
        off = 1 if len(pairs) % 2 == 0 else 32
        if (j % 128 + off < 128 and j + off < tables.valid_count
                and not {j, j + off} & used):
            pairs.append((j, j + off))
            used |= {j, j + off}
        if len(pairs) == 8:
            break
    src = torch.tensor([a for a, _ in pairs], device=cuda)
    dst = torch.tensor([b for _, b in pairs], device=cuda)
    tw = tables.features.shape[1] // 5
    feats = tables.features.clone().view(-1, 5, tw)
    feats[:, :, dst] = feats[:, :, src]
    shade = tables.shade_table.clone()
    shade[dst] = shade[src]
    tied = tables._replace(features=feats.view(-1, 5 * tw).contiguous(),
                           shade_table=shade)
    idx, *_ = _narrow_kernels_agree(tied, rays8, kernel)
    on_src = torch.isin(idx, src.int())
    assert int(on_src.sum()) >= 50 and not torch.isin(idx, dst.int()).any()
    # The ties are real: with the originals gone, the same lanes hit the
    # copies at the same t.
    gone = feats.clone()
    gone[:, :, src] = 0.0
    t_c, idx_c, _ = cuda_dense.full_sweep(
        tied._replace(features=gone.view(-1, 5 * tw).contiguous()), rays8,
        False)
    t_f, _, _ = cuda_dense.full_sweep(tied, rays8, False)
    assert torch.isin(idx_c[on_src], dst.int()).all()
    assert torch.equal(_bits(t_c[on_src]), _bits(t_f[on_src]))


@pytest.mark.parametrize("kernel", ["jobs", "scan"])
def test_narrow_kernels_every_lane_touches_the_same_tiles(cuda, kernel):
    """2,048 copies of one ray through the middle of mixed: every lane of a
    block touches the tiles that any does, so each walked tile queues the
    whole block (128 lanes for 4 warps, 1,024 for 32)."""
    tables, ro, rd = _scene("mixed", cuda)
    mid = RES * (RES // 2) + RES // 2
    one = ray_stack(ro, rd, torch.full((RES * RES,), T_MAX,
                                       device=cuda))[:, mid:mid + 1]
    rays8 = one.expand(8, 2048).contiguous()
    idx, stats, stats_any, b, _ = _narrow_kernels_agree(tables, rays8,
                                                         kernel)
    assert int(idx[0]) >= 0 and (idx == idx[0]).all()
    for st in (stats, stats_any):
        pairs, tiles = _pairs_and_tiles(st, kernel)
        assert int(tiles.sum()) > 0 and torch.equal(pairs, b * tiles)


@pytest.mark.parametrize("kernel", ["jobs", "scan"])
def test_narrow_kernels_one_live_lane(cuda, bounce_stacks, kernel):
    """A stack with exactly one live lane: its block queues one lane a tile
    and every other block is empty."""
    tables, rays8, R = bounce_stacks["mixed"]
    live = torch.nonzero(cuda_dense.full_sweep(tables, rays8, False)[1][R:]
                         >= 0)[0] + R
    rays8 = rays8.clone()
    keep = torch.zeros(2 * R, dtype=torch.bool, device=cuda)
    keep[live] = True
    rays8[6] = torch.where(keep, rays8[6], 0.0)
    idx, stats, stats_any, *_ = _narrow_kernels_agree(tables, rays8,
                                                      kernel)
    assert int((idx >= 0).sum()) == 1
    for st in (stats, stats_any):
        pairs, tiles = _pairs_and_tiles(st, kernel)
        assert int((tiles > 0).sum()) == 1 and torch.equal(pairs, tiles)


@pytest.mark.parametrize("kernel", ["jobs", "scan"])
def test_narrow_kernels_ragged_last_tile(cuda, kernel):
    """special has 564 triangles: its fifth and last tile holds 52, and the
    bounce-1 stack hits them; the staged copy brings the padding along and
    the walk masks it."""
    world = NativeWorld("special")
    world.update_camera(RES, RES)
    tables = build_world_tables(world, "cuda")
    assert tables.valid_count % 128 != 0
    last = tables.valid_count // 128 * 128
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).cuda()
    rays8 = bounce_rays(tables, cam, RES, RES, 1, 8)
    idx, *_ = _narrow_kernels_agree(tables, rays8, kernel)
    assert int((idx >= last).sum()) > 100
    assert int(idx.max()) < tables.valid_count


@pytest.mark.parametrize("chunk", [1, 7, tune.JOB_CHUNK])
def test_job_kernel_split_worklists(cuda, bounce_stacks, monkeypatch, chunk):
    """spheres' fused bounce-1 stack with worklists cut into chunks of 1, 7
    and `tune.JOB_CHUNK` entries, walked by several blocks at once and
    merged by the tie rule: t, idx, rows and occlusion bit-equal to the
    full sweep and the plain versions, the same from a second launch;
    stats as `_hold_job_stats` says."""
    tables, rays8, _ = bounce_stacks["spheres"]
    monkeypatch.setattr(tune, "JOB_CHUNK", chunk)
    *_, split = _narrow_kernels_agree(tables, rays8, "jobs")
    assert split > 0


@pytest.mark.parametrize("copy_up", [True, False])
@pytest.mark.parametrize("chunk", [1, 7, tune.JOB_CHUNK])
def test_job_kernel_cross_chunk_tie(cuda, bounce_stacks, monkeypatch, chunk,
                                    copy_up):
    """spheres' most-hit triangle on its fused bounce-1 stack gets a copy in
    the tile at the far end of the id range from its own (or is moved there
    and copied back into its own tile), the copy's index above the
    original's with copy_up and below it without: the two tiles sit in
    different chunks of worklists that hold both, and the lower index wins
    on every tied lane, bit-equal to the full sweep."""
    tables, rays8, _ = bounce_stacks["spheres"]
    monkeypatch.setattr(tune, "JOB_CHUNK", chunk)
    idx_f = cuda_dense.full_sweep(tables, rays8, False)[1]
    hist = torch.bincount(idx_f[idx_f >= 0].long(),
                          minlength=tables.valid_count)
    home = int(torch.argmax(hist)) // 128
    ct = tables.spheres.shape[0]
    away = 0 if home > ct // 2 else ct - 1
    tied, orig, copy = cross_tile_tie(tables, idx_f, home, away,
                                      (away > home) != copy_up)
    assert (copy > orig) == copy_up
    low, high = min(orig, copy), max(orig, copy)
    idx, *_ = _narrow_kernels_agree(tied, rays8, "jobs")
    assert int((idx == low).sum()) >= 20 and not (idx == high).any()
    # The ties are real: without the lower one, the same lanes hit the
    # higher at the same t.
    tw = tied.features.shape[1] // 5
    gone = tied.features.clone().view(-1, 5, tw)
    gone[:, :, low] = 0.0
    t_c, idx_c, _ = cuda_dense.full_sweep(
        tied._replace(features=gone.view(-1, 5 * tw).contiguous()), rays8,
        False)
    t_f, _, _ = cuda_dense.full_sweep(tied, rays8, False)
    on_low = idx == low
    assert (idx_c[on_low] == high).all()
    assert torch.equal(_bits(t_c[on_low]), _bits(t_f[on_low]))
    rays_s, _ = coherence_sort(rays8, tied.box, 128, 0)
    order, counts = cuda_jobs.worklists(tied.spheres, rays_s, 128, tied.box)
    pos = torch.full((counts.shape[0], ct), -1, dtype=torch.long,
                     device=cuda)
    k = torch.arange(ct, device=cuda).expand_as(order)
    on = k < counts[:, None]
    pos[torch.nonzero(on, as_tuple=True)[0], order[on].long()] = k[on]
    both = (pos[:, home] >= 0) & (pos[:, away] >= 0)
    assert both.any()
    assert (pos[both, home] // chunk != pos[both, away] // chunk).any()


# -- the product surface on the card ------------------------------------------

def _skinned_renderer(dev, res=64, depth=4):
    return Renderer("viewer", glb_data=skinned_strip_glb(),
                    config=RenderConfig(width=res, height=res,
                                        max_depth=depth, shader_spp=1,
                                        fps=10, spp=2, batch=2),
                    device=dev)


def test_recorder_frames_match_cpu(cuda):
    """record_chunks on the skinned strip, 64^2 d4 spp 2, 3 frames: the
    card's PNG frames against the CPU's (the plain versions) within the
    slice tolerance, LDR within 1 code on >= 95% of pixels and means
    within 2%."""
    from webgpu_raytracer_tpu_torch.render.recorder import VideoRecorder
    from webgpu_raytracer_tpu_torch.utils.textures import decode_png

    got = {}
    for dev in ("cpu", cuda):
        r = _skinned_renderer(dev)
        got[str(dev)] = VideoRecorder(r).record_chunks(r.config, 0, 3)
    for a, b in zip(got["cpu"], got["cuda"]):
        assert a.frame_index == b.frame_index
        ia = decode_png(a.data).astype(np.int32)
        ib = decode_png(b.data).astype(np.int32)
        assert ib.shape == (64, 64, 3) and ib.mean() > 1.0
        assert (np.abs(ia - ib) <= 1).mean() >= 0.95
        assert abs(ia.mean() - ib.mean()) <= 0.02 * ia.mean()


def test_checkpoint_resume_bit_identical(cuda, tmp_path):
    from webgpu_raytracer_tpu_torch.render.checkpoint import (
        load_checkpoint, save_checkpoint)

    cfg = dict(width=96, height=64, max_depth=4)
    whole = Renderer("cornell", config=RenderConfig(**cfg), device=cuda)
    half = Renderer("cornell", config=RenderConfig(**cfg), device=cuda)
    for _ in range(6):
        whole.render_frame()
    for _ in range(3):
        half.render_frame()
    save_checkpoint(str(tmp_path / "ck"), half)
    resumed = Renderer("cornell", config=RenderConfig(**cfg), device=cuda)
    assert load_checkpoint(str(tmp_path / "ck"), resumed)
    assert resumed.accum.device.type == "cuda"
    for _ in range(3):
        resumed.render_frame()
    assert torch.equal(resumed.accum.view(torch.int32),
                       whole.accum.view(torch.int32))


def test_bridge_overlap_bit_equal_on_card(cuda):
    over, seq = _skinned_renderer(cuda), _skinned_renderer(cuda)
    times = [(1 + k) / 30.0 for k in range(6)]
    over.bridge.update_async(times[0])
    for k, t in enumerate(times):
        over.bridge.wait()
        over.reupload_scene()
        if k + 1 < len(times):
            over.bridge.update_async(times[k + 1])
        over.render_frame()
        seq.update_scene(t)
        seq.render_frame()
        assert torch.equal(over.accum.view(torch.int32),
                           seq.accum.view(torch.int32)), k


def test_farm_on_card_byte_equal_to_solo(cuda):
    """A Coordinator and two WorkerClient(device="cuda") threads render
    cornell at 64x48 depth 4, spp 2, 4 frames in jobs of 2: the frames
    byte-equal to a solo record_chunks on the card."""
    from webgpu_raytracer_tpu_torch.parallel.cluster import (
        Coordinator, WorkerClient, _default_renderer_factory)
    from webgpu_raytracer_tpu_torch.render.recorder import VideoRecorder

    config = RenderConfig(width=64, height=48, max_depth=4, shader_spp=1,
                          spp=2, fps=4, duration=1.0)
    solo = VideoRecorder(_default_renderer_factory(
        config, "cornell", None, b"", device=cuda)).record_chunks(config, 0,
                                                                  4)
    coord = Coordinator(secret="card")
    workers = [WorkerClient("127.0.0.1", coord.port, secret="card",
                            device=cuda) for _ in range(2)]
    errors = []

    def work(w):
        try:
            w.connect()
            w.run()
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(w,), daemon=True)
               for w in workers]
    try:
        coord.set_scene(config, "cornell")
        for t in threads:
            t.start()
        coord.start_render(total_frames=4, job_batch=2)
        assert coord.wait(300.0), (coord.admin_status(), errors)
        frames = coord.collect_frames()
    finally:
        for w in workers:
            w.close()
        coord.close()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    assert [f.frame_index for f in frames] == [0, 1, 2, 3]
    for f, ref in zip(frames, solo):
        assert f.data == ref.data, f.frame_index


def test_cli_render_on_card(cuda, tmp_path):
    """`cli render` on its default device, the card (64x48, 8 frames, live
    preview on), and `cli info`, each in a subprocess: both exit 0, and the
    PNG decodes to 48 x 64 and is not black."""
    from webgpu_raytracer_tpu_torch.utils.textures import decode_png

    out = tmp_path / "cli.png"
    for argv in (["render", "--scene", "cornell", "--width", "64",
                  "--height", "48", "--frames", "8", "--preview", "0",
                  "--output", str(out)], ["info", "--scene", "cornell"]):
        proc = subprocess.run(
            [sys.executable, "-m", "webgpu_raytracer_tpu_torch.cli", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (argv, proc.stdout, proc.stderr)
    img = decode_png(out.read_bytes())
    assert img.shape == (48, 64, 3) and img.mean() > 10


def test_profiling_on_card(cuda, tmp_path):
    """A captured frame's spans under `tracing()` (the capture at the first
    call of a key, a replay at the next), the capture counters, and
    device_trace's Chrome trace: the card's kernels and the program's
    spans, the graph launch inside `steps.replay` on one clock."""
    import json

    from webgpu_raytracer_tpu_torch.utils.profiling import (counters,
                                                            device_trace,
                                                            span, spans,
                                                            tracing)

    before = counters()
    r = Renderer("cornell", config=RenderConfig(width=64, height=64,
                                                max_depth=2), device=cuda)
    with tracing():
        with span("mark") as mark:
            pass
        r.render_frame()
        r.render_frame()
    names = [s.name for s in spans() if s.id > mark.id]
    assert names.count("steps.capture") == 1
    assert names.count("steps.feed") == 1 and names.count("render_frame") == 2
    after = counters()
    assert after["captures"] - before.get("captures", 0) == 1
    assert after["capture_ms"] > before.get("capture_ms", 0)
    with device_trace(str(tmp_path / "trace")):
        r.render_frame()
        torch.cuda.synchronize()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("dense_sweep" in str(e.get("name", "")) for e in events)
    replay = [e for e in events if e.get("cat") == "span"
              and e["name"] == "steps.replay"]
    launch = [e for e in events
              if str(e.get("name", "")).startswith("cudaGraphLaunch")]
    assert len(replay) == 1 and len(launch) == 1
    assert replay[0]["ts"] <= launch[0]["ts"]
    assert launch[0]["ts"] + launch[0]["dur"] <= \
        replay[0]["ts"] + replay[0]["dur"]


# --- the BVH walk (csrc/bvh_walk.cu) -----------------------------------------


def _bvh_rays(name, dev, n_random=2048):
    """(DeviceScene on dev, ro (R, 3), rd (R, 3)): the RES^2 pinhole
    primaries, then random rays from the scene box's middle (every 7th
    with a zero direction component, which safe_inv nudges)."""
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    world = NativeWorld(name)
    world.update_camera(RES, RES)
    scene = build_device_scene(world, device=dev)
    _, ro, rd = _scene(name, dev)
    rs = np.random.default_rng(len(name))
    ro_r = rs.uniform(-1.5, 1.5, (n_random, 3)).astype(np.float32)
    rd_r = rs.normal(size=(n_random, 3)).astype(np.float32)
    rd_r[::7, 1] = 0.0
    ro = torch.cat([torch.stack(list(ro), 1),
                    torch.from_numpy(ro_r).to(dev)]).contiguous()
    rd = torch.cat([torch.stack(list(rd), 1),
                    torch.from_numpy(rd_r).to(dev)]).contiguous()
    return scene, ro, rd


@pytest.mark.parametrize("scene_name", ["cornell", "mesh", "mixed"])
def test_bvh_walk_matches_plain(cuda, scene_name):
    """Closest and any-hit, bit for bit with the plain walk on the same
    CUDA tensors (t, tri, inst, occluded, nodes and triangles counted), the
    same from a second launch; every 5th lane inactive, shadow t_max per
    lane."""
    from webgpu_raytracer_tpu_torch.ops import intersect

    scene, ro, rd = _bvh_rays(scene_name, cuda)
    R = ro.shape[0]
    active = torch.arange(R, device=cuda) % 5 != 0
    before = dict(kernels.launches)
    runs = [intersect.intersect_closest(scene, ro, rd, active=active,
                                        with_stats=True) for _ in range(2)]
    plain, pst = intersect.traverse_plain(scene, ro, rd, intersect.T_MIN,
                                          intersect.T_MAX, active, False)
    for hit, st in runs:
        for a, b in zip((*hit, *st), (*plain, *pst)):
            assert torch.equal(a, b)
    hit = runs[0][0]
    assert (hit.inst_idx >= 0).float().mean() > 0.3
    t_max = torch.where(torch.arange(R, device=cuda) % 2 == 0,
                        hit.t * 0.5, hit.t * 1.01)
    t_max = torch.where(hit.inst_idx >= 0, t_max, 5.0).contiguous()
    occ = [intersect.intersect_shadow(scene, ro, rd, t_max, active=active,
                                      with_stats=True) for _ in range(2)]
    occ_p, ost = intersect.traverse_plain(scene, ro, rd, intersect.T_MIN,
                                          t_max, active, True)
    for o, st in occ:
        assert torch.equal(o, occ_p)
        assert torch.equal(st.nodes, ost.nodes)
        assert torch.equal(st.tris, ost.tris)
    assert 0 < int(occ_p.sum()) < R
    assert kernels.launches["bvh_closest"] == before["bvh_closest"] + 2
    assert kernels.launches["bvh_shadow"] == before["bvh_shadow"] + 2
    assert kernels.launches["bvh_walk"] == before["bvh_walk"] + 4


def test_bvh_walk_edges(cuda):
    """One ray; all lanes inactive; a wrong device or dtype raises."""
    from webgpu_raytracer_tpu_torch.ops import intersect

    scene, ro, rd = _bvh_rays("cornell", cuda, n_random=0)
    one = intersect.intersect_closest(scene, ro[:1].contiguous(),
                                      rd[:1].contiguous())
    plain, _ = intersect.traverse_plain(
        scene, ro[:1], rd[:1], intersect.T_MIN, intersect.T_MAX,
        torch.ones(1, dtype=torch.bool, device=cuda), False)
    assert all(torch.equal(a, b) for a, b in zip(one, plain))
    none = torch.zeros(ro.shape[0], dtype=torch.bool, device=cuda)
    hit, st = intersect.intersect_closest(scene, ro, rd, active=none,
                                          with_stats=True)
    assert (hit.inst_idx == -1).all() and (st.nodes == 0).all()
    assert not intersect.intersect_shadow(scene, ro, rd, 1e30,
                                          active=none).any()
    with pytest.raises(TypeError):
        intersect.walk_cuda(scene, ro.double(), rd, intersect.T_MIN,
                            intersect.T_MAX, None, False)


def test_bvh_trace_on_card_counts_launches(cuda):
    """trace_pixels at depth 3, spp 2: 2 x 3 closest walks (the primary,
    two extensions), 2 x 3 shades and 2 x 3 shadow walks a frame; the frame
    close to the plain versions' on the CPU (>= 95% of lanes at rel <
    1e-3)."""
    from webgpu_raytracer_tpu_torch.ops.trace import trace_pixels
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    world = NativeWorld("cornell")
    world.update_camera(32, 32)
    frames = []
    for dev in ("cpu", "cuda"):
        scene = build_device_scene(world, device=dev)
        cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
        kernels.reset_launches()
        frames.append(trace_pixels(scene, cam, 1, torch.zeros(2, device=dev),
                                   32, 32, 2, 3).cpu())
    counts = {k: v for k, v in kernels.launches.items() if v}
    assert counts == {"bvh_closest": 6, "bvh_shadow": 6, "bvh_walk": 12,
                      "bvh_shade": 6}
    assert frames[1].mean() > 0.05
    close = torch.isclose(frames[1], frames[0], rtol=1e-3, atol=1e-5).all(1)
    assert close.float().mean() >= 0.95


def test_bvh_trace_spheres_on_card_matches_cpu(cuda):
    """trace_pixels on `spheres` (257,136 triangles) at 16^2 depth 3: 3
    of each walk and 3 shades a frame; the frame close to the plain
    versions' on the CPU (>= 95% of lanes at rel < 1e-3)."""
    from webgpu_raytracer_tpu_torch.ops.trace import trace_pixels

    frames = []
    for dev in ("cpu", "cuda"):
        sc, cam = torch_scenes.bvh_scene("spheres", 16, 16, dev)
        kernels.reset_launches()
        frames.append(trace_pixels(sc, cam, 1, torch.zeros(2, device=dev),
                                   16, 16, 1, 3).cpu())
    assert _launched() == {"bvh_closest": 3, "bvh_shadow": 3, "bvh_walk": 6,
                           "bvh_shade": 3}
    assert frames[1].mean() > 0.0
    close = torch.isclose(frames[1], frames[0], rtol=1e-3, atol=1e-5).all(1)
    assert close.float().mean() >= 0.95


def test_bvh_and_dense_tracers_agree_on_card(cuda):
    """`get_tracer("bvh")` and `get_tracer("dense")` on one cornell frame
    at 64^2 depth 8: >= 98% of lanes within 1e-3; the dense frame launches
    9 sweeps and 8 shades, the BVH frame 8 of each walk and 8 shades."""
    from webgpu_raytracer_tpu_torch.ops.api import get_tracer
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    world = NativeWorld("cornell")
    world.update_camera(RES, RES)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(cuda)
    jitter = torch.zeros(2, device=cuda)
    scenes = {"bvh": build_device_scene(world, device=cuda),
              "dense": (build_world_tables(world, cuda), None)}
    kernels.reset_launches()
    cols = {b: get_tracer(b)(scene, cam, 1, jitter, RES, RES, 1, 8)
            for b, scene in scenes.items()}
    assert _launched() == {"dense_sweep": 9, "shade_rows": 8,
                           "bvh_closest": 8, "bvh_shadow": 8, "bvh_walk": 16,
                           "bvh_shade": 8}
    close = torch.isclose(cols["bvh"], cols["dense"], rtol=1e-3,
                          atol=1e-3).all(1)
    assert close.float().mean() >= 0.98


# BVH shade cases: preset, or GLB maker in the viewer scene.
BVH_SHADE = {"cornell": ("cornell", None), "mixed": ("mixed", None),
             "special": ("special", None),
             "textured": ("viewer", torch_scenes.textured_quad_glb),
             "textured_light": ("viewer", torch_scenes.textured_light_glb),
             "formats": ("viewer", torch_scenes.formats_scene_glb)}


@pytest.mark.parametrize("scene,depth", [
    ("cornell", 0), ("cornell", 4), ("mixed", 0), ("mixed", 2),
    ("textured", 0), ("textured", 4), ("textured_light", 0),
    ("textured_light", 4), ("formats", 0), ("formats", 2)])
def test_bvh_shade_kernel_matches_plain(cuda, scene, depth):
    """`csrc/bvh_shade.cu` (both instantiations) against `bvh_shade_step`
    on bounce `depth` of a 64^2 frame, advanced there through the kernels:
    rng words equal, flags equal on every lane, values within rtol 1e-4
    (near-mirror GGX lanes 5e-2), one launch
    (`torch_scenes.hold_bvh_shade`)."""
    name, glb = BVH_SHADE[scene]
    sc, cam = torch_scenes.bvh_scene(name, RES, RES, cuda,
                                   glb() if glb else None)
    assert sc.textures.is_floating_point() == (glb is None)
    args = torch_scenes.bvh_bounce_inputs(sc, cam, RES, RES, depth)
    before = kernels.launches["bvh_shade"]
    torch_scenes.hold_bvh_shade(f"{scene} depth {depth}", args)
    assert kernels.launches["bvh_shade"] == before + 1


def _lanes(args, keep, ro_offset=0):
    """bvh_shade's arguments cut to the lanes in `keep`, every per-lane
    tensor contiguous; ro and rd start `ro_offset` floats into a buffer
    (not 16-byte aligned when ro_offset % 4)."""
    scene, state, rng, ro, rd, active, tri, inst, occ, depth, md = args

    def cut(x):
        return None if x is None else x[keep].contiguous()

    def shifted(x):
        x = x[keep]
        buf = torch.empty(x.numel() + ro_offset, dtype=x.dtype,
                          device=x.device)
        out = buf[ro_offset:].view(x.shape)
        out.copy_(x)
        return out

    return (scene, state[:, keep].contiguous(), cut(rng), shifted(ro),
            shifted(rd), cut(active), cut(tri), cut(inst), cut(occ), depth,
            md)


@pytest.mark.parametrize("scene,depth,cut,offset", [
    ("cornell", 0, 37, 0), ("mixed", 2, 1, 1), ("special", 0, 255, 0),
    ("textured_light", 4, 129, 3)])
def test_bvh_shade_kernel_ragged_and_unaligned(cuda, scene, depth, cut,
                                               offset):
    """R one to 255 lanes short of a whole block (the last block's rows
    staged one float a thread), and ro / rd not 16-byte aligned (the
    staged loads' scalar path): the kernel against `bvh_shade_step`."""
    name, glb = BVH_SHADE[scene]
    sc, cam = torch_scenes.bvh_scene(name, RES, RES, cuda,
                                   glb() if glb else None)
    args = torch_scenes.bvh_bounce_inputs(sc, cam, RES, RES, depth)
    keep = torch.arange(RES * RES - cut, device=cuda)
    args = _lanes(args, keep, offset)
    assert args[3].shape[0] % 256 and (args[3].data_ptr() % 16 != 0) == (
        offset % 4 != 0)
    torch_scenes.hold_bvh_shade(f"{scene} depth {depth}, {keep.numel()} "
                              f"lanes, ro offset {offset}", args)


def test_bvh_shade_kernel_all_inactive(cuda):
    """No lane walked: every lane draws six, keeps its state (radiance
    plus the resolved pending NEE) and walks nothing, as the plain step."""
    sc, cam = torch_scenes.bvh_scene("cornell", RES, RES, cuda)
    args = list(torch_scenes.bvh_bounce_inputs(sc, cam, RES, RES, 2))
    args[5] = torch.zeros_like(args[5])
    torch_scenes.hold_bvh_shade("cornell depth 2, all inactive", tuple(args))
    out, _, nxt = bvh_shade.bvh_shade(*args)
    assert not bool(nxt.do_next.any() | nxt.nee_lane.any())
    assert not bool(out[bvh_shade.PEND].any())
    for x in (nxt.ro, nxt.rd, nxt.sro, nxt.srd, nxt.s_tmax):
        assert not bool(x.any())


@pytest.mark.parametrize("scene", ["mixed", "special"])
def test_bvh_shade_kernel_three_material_mix(cuda, scene):
    """Bounce 0 of a scene whose hits mix Lambert, GGX metal and
    dielectric lanes in one warp: the kernel against the plain step."""
    sc, cam = torch_scenes.bvh_scene(scene, RES, RES, cuda)
    args = torch_scenes.bvh_bounce_inputs(sc, cam, RES, RES, 0)
    found = args[7] >= 0
    mats = sc.tri_mat[args[6][found].long()]
    assert all(bool((mats == m).any()) for m in (0, 1, 2))
    warp_mats = torch.where(found, sc.tri_mat[args[6].clamp(min=0).long()],
                            -1).reshape(-1, 32)
    mixed = [(warp_mats == m).any(1) for m in (0, 1, 2)]
    assert bool((mixed[0] & mixed[1] & mixed[2]).any())
    torch_scenes.hold_bvh_shade(f"{scene} depth 0, three materials", args)


@pytest.mark.parametrize("scene", sorted(BVH_SHADE))
def test_shade_pack_on_card_equals_cpu(cuda, scene):
    """`pack_shade` on the card holds the same bits as on the CPU (the
    light corners' products and sums included), with the kernel's view."""
    name, glb = BVH_SHADE[scene]
    data = glb() if glb else None
    packs = [bvh_shade.pack_shade(torch_scenes.bvh_scene(
        name, 16, 16, dev, data)[0]) for dev in ("cpu", cuda)]
    for a, b in zip(packs[0][:3], packs[1][:3]):
        assert torch.equal(a, b.cpu())
    assert packs[0].view is None and packs[1].view is not None
    assert packs[1].textured == (glb is not None)


def test_bvh_shade_writes_into_out(cuda):
    """`out=`: the kernel writes into an earlier call's outputs, bit-equal
    to a call that makes its own; an `out` of another lane count raises
    and launches nothing."""
    sc, cam = torch_scenes.bvh_scene("mixed", RES, RES, cuda)
    args = torch_scenes.bvh_bounce_inputs(sc, cam, RES, RES, 1)
    pack = bvh_shade.pack_shade(sc)
    want = bvh_shade.bvh_shade(*args, pack=pack)
    out = bvh_shade.shade_outputs(RES * RES, cuda)
    for t in (out[0], out[1], *out[2]):
        t.fill_(7)
    got = bvh_shade.bvh_shade(*args, pack=pack, out=out)
    assert got is out
    for a, b in zip((want[0], want[1], *want[2]), (out[0], out[1], *out[2])):
        assert torch.equal(a, b)
    before = kernels.launches["bvh_shade"]
    with pytest.raises(ValueError):
        bvh_shade.bvh_shade(*args, pack=pack,
                            out=bvh_shade.shade_outputs(RES, cuda))
    assert kernels.launches["bvh_shade"] == before


def test_bvh_shade_rejects_bad_inputs(cuda):
    """The wrapper checks every tensor before it launches: a wrong dtype,
    shape or device raises and counts no launch."""
    sc, cam = torch_scenes.bvh_scene("cornell", 16, 16, cuda)
    args = list(torch_scenes.bvh_bounce_inputs(sc, cam, 16, 16, 1))
    before = kernels.launches["bvh_shade"]
    for k, bad in ((2, args[2].to(torch.int32)), (3, args[3][:, :2]),
                   (5, args[5].float()), (6, args[6].cpu()),
                   (1, args[1][:-1])):
        broken = list(args)
        broken[k] = bad
        with pytest.raises((TypeError, ValueError)):
            bvh_shade.bvh_shade(*broken)
    # A pack of another scene, or built on the CPU.
    other = torch_scenes.bvh_scene("mixed", 16, 16, cuda)[0]
    for pack in (bvh_shade.pack_shade(other), bvh_shade.pack_shade(
            torch_scenes.bvh_scene("cornell", 16, 16, "cpu")[0])):
        with pytest.raises(ValueError):
            bvh_shade.bvh_shade(*args, pack=pack)
    assert kernels.launches["bvh_shade"] == before


def _walk_bit_equal(scene, ro, rd, t_max, active, pack=None):
    """Closest (t_max 1e30) and any-hit (t_max per lane) through the
    kernel, twice each, bit-equal to the plain walk on the same CUDA
    tensors, results and counts (`torch_scenes.walk_bit_equal`). Returns the
    closest hits."""
    from webgpu_raytracer_tpu_torch.ops import intersect

    hit = torch_scenes.walk_bit_equal(scene, ro, rd, intersect.T_MAX, active,
                                    False, "closest", pack)[0]
    torch_scenes.walk_bit_equal(scene, ro, rd, t_max, active, True, "any-hit",
                              pack)
    return hit


@pytest.mark.parametrize("scene_name", ["cornell", "mixed"])
def test_bvh_walk_nonfinite_lanes_bit_equal(cuda, scene_name):
    """Lanes with NaN or inf in o, d or t_max take the kernel's exact slab
    test and their neighbours the fast one: closest (t_max per lane for
    the shadow walk only) and any-hit bit for bit with the plain walk,
    counts included, with the pack given and built."""
    from webgpu_raytracer_tpu_torch.ops import intersect

    scene, ro, rd = _bvh_rays(scene_name, cuda, n_random=4096)
    R = ro.shape[0]
    t_max = torch.from_numpy(np.random.default_rng(R).uniform(
        0.5, 6.0, R).astype(np.float32)).to(cuda)
    ro, rd, t_max = torch_scenes.poison_lanes(ro, rd, t_max, R)
    active = torch.arange(R, device=cuda) % 11 != 0
    pack = intersect.pack_walk(scene)
    for pk in (pack, None):
        hit = _walk_bit_equal(scene, ro, rd, t_max, active, pk)
    assert (hit.inst_idx >= 0).float().mean() > 0.2


@pytest.mark.parametrize("scene_name", ["cornell", "mixed"])
def test_bvh_walk_exact_path_on_infinite_bounds(cuda, scene_name):
    """A scene whose node bounds hold an inf (the TLAS root widened to
    +-inf on one axis each way, a BLAS node's max to +inf) packs with
    finite = 0, and every lane takes the exact slab test: bit for bit with
    the plain walk on the same scene."""
    from webgpu_raytracer_tpu_torch.ops import intersect

    scene, ro, rd = _bvh_rays(scene_name, cuda)
    nmin, nmax = scene.node_min.clone(), scene.node_max.clone()
    nmin[0, 0] = -float("inf")
    nmax[0, 2] = float("inf")
    blas = int(scene.inst_blas[0])
    nmax[blas + 1, 1] = float("inf")
    wide = scene._replace(node_min=nmin, node_max=nmax)
    pack = intersect.pack_walk(wide)
    assert int(pack.finite) == 0
    R = ro.shape[0]
    t_max = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 6.0, R).astype(np.float32)).to(cuda)
    active = torch.arange(R, device=cuda) % 5 != 0
    hit = _walk_bit_equal(wide, ro, rd, t_max, active, pack)
    assert (hit.inst_idx >= 0).float().mean() > 0.3


def test_bvh_walk_more_rays_than_the_card_holds(cuda):
    """1,000,003 rays on cornell (more than the card holds threads, the
    last block ragged), 3 in 4 dead, the live ones in runs of uneven
    length: bit for bit with the plain walk, results and counts, from two
    launches."""
    from webgpu_raytracer_tpu_torch.ops import intersect
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    scene = build_device_scene(NativeWorld("cornell"), device=cuda)
    rs = np.random.default_rng(9)
    R = 1_000_003
    ro = torch.from_numpy(rs.uniform(-0.9, 0.9, (R, 3)).astype(
        np.float32)).to(cuda)
    ro[:, 1] = ro[:, 1].abs() + 0.05
    rd = torch.from_numpy(rs.normal(size=(R, 3)).astype(np.float32)).to(cuda)
    t_max = torch.from_numpy(rs.uniform(0.1, 3.0, R).astype(np.float32)).to(
        cuda)
    active = torch.from_numpy((rs.uniform(size=R) < 0.25)
                              | (np.arange(R) % 1000 < 37)).to(cuda)
    pack = intersect.pack_walk(scene)
    hit = _walk_bit_equal(scene, ro, rd, t_max, active, pack)
    live_hits = ((hit.inst_idx >= 0) & active).sum() / active.sum()
    assert float(live_hits) > 0.8  # the box is open towards the camera


# --- the present step (csrc/present.cu) -------------------------------------

PRESENT_SIZES = {"720x480": (480, 720), "1920x1080": (1080, 1920),
                 "37x23": (23, 37)}


@pytest.mark.parametrize("unjitter", [True, False])
@pytest.mark.parametrize("size", sorted(PRESENT_SIZES))
def test_present_kernel_bit_equal_to_plain(cuda, size, unjitter):
    """The two passes against `postprocess` on the card, image and history
    bit for bit: frames 1, 2, 16 (resampled on the unjitter graph), 17 and
    5,000 (k = 60, alpha 1/5000), a sub-pixel jitter and one that moves
    every resample tap past the edge; zero-count pixels and 1e6 fireflies
    (`torch_scenes.present_inputs`); 37x23 is smaller than a block."""
    height, width = PRESENT_SIZES[size]
    acc, hist = torch_scenes.present_inputs(height, width, height + width,
                                            cuda)
    for jitter in torch_scenes.PRESENT_JITTERS:
        jit = torch.tensor(jitter, dtype=torch.float32, device=cuda)
        for frame in (1, 2, 16, 17, 5000):
            torch_scenes.hold_present(acc, hist, frame, jit, unjitter)


def test_present_step_captured_equals_eager(cuda):
    """`present_step` through `CapturedSteps` over frames 1-18 (the
    unjitter graph to frame 16, then the one without the resample), the
    accumulator changed in place between frames: image and history bit for
    bit with the eager step's, the donated history returned written, two
    captures, two launches counted at each replay."""
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            present_step)

    height, width = 23, 37
    acc, hist = torch_scenes.present_inputs(height, width, 5, cuda)
    accum = acc.view(height * width, 4)
    jit = torch.tensor(torch_scenes.PRESENT_JITTERS[0], device=cuda)
    frame = torch.zeros((), dtype=torch.int64, device=cuda)
    steps = CapturedSteps(cuda)
    hist_g, hist_e = hist.clone(), hist.clone()
    for f in range(1, 19):
        accum[f::7, :3] *= 1.25
        frame.fill_(f)
        static = dict(width=width, height=height, unjitter=f <= 16)
        given = hist_g
        before = kernels.launches["present"]
        (ldr_g, hist_g), _ = steps.run(present_step,
                                       (accum, hist_g, frame, jit), static,
                                       donate=(1,))
        assert kernels.launches["present"] == before + cuda_present.LAUNCHES
        assert hist_g is given
        ldr_e, out = present_step(accum, hist_e, frame, jit, **static)
        assert out is hist_e
        assert torch.equal(ldr_g, ldr_e), f
        assert torch.equal(hist_g.view(torch.int32),
                           hist_e.view(torch.int32)), f
    assert len(steps.captures) == 2


def test_present_wrapper_raises_on_card(cuda):
    """The wrapper raises before it launches on an accumulator that is not
    16-byte aligned, a history on another device and a frame count that is
    not int64; nothing is counted."""
    acc, hist = torch_scenes.present_inputs(4, 6, 1, cuda)
    jit = torch.zeros(2, device=cuda)
    before = dict(kernels.launches)
    shifted = torch.zeros(4 * 6 * 4 + 1, device=cuda)[1:].view(4, 6, 4)
    with pytest.raises(ValueError, match="aligned"):
        cuda_present.present(shifted, hist, 1, jit)
    with pytest.raises(ValueError, match="history: on cpu"):
        cuda_present.present(acc, hist.cpu(), 1, jit)
    with pytest.raises(ValueError, match="frame_count"):
        cuda_present.present(acc, hist, torch.tensor(1, dtype=torch.int32,
                                                     device=cuda), jit)
    assert kernels.launches == before


# --- the captured frame steps (render/renderer.py) ---------------------------

# path -> (scene, GLB maker, use_gbuffer, narrow)
STEP_PATHS = {"single-tile": ("cornell", None, False, "jobs"),
              "jobs": ("spheres", None, False, "jobs"),
              "scan": ("spheres", None, False, "scan"),
              "textured": ("viewer", torch_scenes.textured_quad_glb, False,
                           "jobs"),
              "seeded": ("viewer", torch_scenes.textured_quad_glb, True,
                         "jobs")}


def _eager_and_captured(name, glb, narrow, dev, depth=3):
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            EagerSteps)

    cfg = dict(width=RES, height=RES, max_depth=depth)
    eager, graph = (Renderer(name, config=RenderConfig(**cfg), device=dev,
                             glb_data=glb() if glb else None, narrow=narrow)
                    for _ in range(2))
    eager.steps = EagerSteps()
    assert isinstance(graph.steps, CapturedSteps)
    return eager, graph


def _bit_equal_frames(eager, graph, n, use_gbuffer=False):
    for _ in range(n):
        a = eager.render_frame(use_gbuffer).clone()
        b = graph.render_frame(use_gbuffer).clone()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            graph.frame_count
        assert float(eager.last_rays) == float(graph.last_rays)
        np.testing.assert_array_equal(eager.present(), graph.present())


@pytest.mark.parametrize("path", sorted(STEP_PATHS))
def test_captured_steps_bit_equal_to_eager(cuda, path):
    """18 frames (past the resample's 16) through captured steps against
    the eager steps: accumulator, image and ray count bit for bit; one
    capture per step key (render_step, present_step, and present_step
    without the resample from frame 17); the launch counts n x the eager
    frame's, those of the captures not counted."""
    name, glb, use_gbuffer, narrow = STEP_PATHS[path]
    eager, graph = _eager_and_captured(name, glb, narrow, cuda)
    n = 18
    _bit_equal_frames(eager, graph, n, use_gbuffer)
    assert len(graph.steps.captures) == 3
    assert graph.launches == eager.launches
    assert all(v % n == 0 for v in graph.launches.values())
    assert graph.steps.pool_bytes() > 0


def test_captured_steps_keys(cuda):
    """build_pipeline and a resize capture anew (the old size's entries
    dropped); an equal-shape reupload of the skinned strip captures
    nothing and the frames stay bit-equal to the eager ones."""
    eager, graph = _eager_and_captured("cornell", None, "jobs", cuda)
    _bit_equal_frames(eager, graph, 2)
    for r in (eager, graph):
        r.build_pipeline(2, 1)
    _bit_equal_frames(eager, graph, 2)
    assert len(graph.steps.captures) == 3
    for r in (eager, graph):
        r.update_screen_size(48, 32)
    _bit_equal_frames(eager, graph, 2)
    assert len(graph.steps.captures) == 5 and len(graph.steps.entries) == 2
    from webgpu_raytracer_tpu_torch.render.renderer import EagerSteps

    eager, graph = _skinned_renderer(cuda), _skinned_renderer(cuda)
    eager.steps = EagerSteps()
    for k in range(6):
        for r in (eager, graph):
            r.update_scene(k / 30.0, reset=False)
        _bit_equal_frames(eager, graph, 1)
    assert len(graph.steps.captures) == 2


def test_captured_bvh_step_bit_equal_to_eager(cuda):
    """render_step(backend="bvh") through CapturedSteps against the eager
    step, 3 frames; then a scene of other values and equal shapes is
    copied in (its walk and shade packs rebuilt into the graph's), and the
    frame still equals the eager one."""
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            render_step)
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    world = NativeWorld("cornell")
    world.update_camera(RES, RES)
    scene = build_device_scene(world, device=cuda)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(cuda)
    static = dict(width=RES, height=RES, spp=1, max_depth=4, backend="bvh",
                  use_gbuffer=False, narrow="jobs")
    steps = CapturedSteps(cuda)
    jit = torch.zeros(2, device=cuda)
    frame = torch.zeros((), dtype=torch.int64, device=cuda)
    acc_e = torch.zeros((RES * RES, 4), device=cuda)
    acc_g = torch.zeros((RES * RES, 4), device=cuda)
    moved = scene._replace(pos=scene.pos + torch.tensor([0.0, 0.05, 0.0],
                                                        device=cuda))
    for f, s in ((1, scene), (2, scene), (3, scene), (4, moved)):
        frame.fill_(f)
        acc_e, rays_e = render_step(s, cam, frame, jit, acc_e, **static)
        (acc_g, rays_g), args = steps.run(
            render_step, (s, cam, frame, jit, acc_g), static, donate=(4,))
        assert args[0] is scene
        assert torch.equal(acc_e.view(torch.int32), acc_g.view(torch.int32))
        assert float(rays_e) == float(rays_g)
    assert len(steps.captures) == 1


def test_capture_of_a_host_sync_raises(cuda):
    """A step that reads a device value on the host cannot be captured: the
    capture raises (no eager fallback), and the cache still captures a
    good step afterwards."""
    from webgpu_raytracer_tpu_torch.render.renderer import CapturedSteps

    steps = CapturedSteps(cuda)
    x = torch.ones(4, device=cuda)

    def syncs(x, *, width, height):
        return (x * float(x.sum()),)

    def good(x, *, width, height):
        return (x * 2.0,)

    with pytest.raises(RuntimeError):
        steps.run(syncs, (x,), dict(width=1, height=1))
    assert not steps.entries
    torch.cuda.synchronize()
    (y,), _ = steps.run(good, (x,), dict(width=1, height=1))
    assert torch.equal(y, x * 2.0)


# --- the sharded steps as captured steps (parallel/sharding.py) --------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def nccl_world():
    """An NCCL process group of one rank in this process, on a free port:
    (1-D mesh, 1 x 1 ("tile", "sample") mesh); destroyed at teardown."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import torch.distributed as dist

    from webgpu_raytracer_tpu_torch.parallel import sharding

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    yield (sharding.make_mesh("cuda"),
           sharding.make_mesh("cuda", (1, 1), ("tile", "sample")))
    dist.destroy_process_group()


def _sharded(kind, meshes, backend, spp=2, depth=3):
    from webgpu_raytracer_tpu_torch.parallel import sharding

    mesh, mesh2 = meshes
    if kind == "tile":
        return sharding.tile_sharded_step(mesh, RES, RES, spp, depth,
                                          backend=backend)
    if kind == "sample":
        return sharding.sample_sharded_step(mesh, RES, RES, spp, depth,
                                            backend=backend)
    return sharding.tile_sample_sharded_step(mesh2, RES, RES, spp, depth,
                                             backend=backend)


def _shard_scene(backend, dev):
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    world = NativeWorld("cornell")
    world.update_camera(RES, RES)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    if backend == "bvh":
        return build_device_scene(world, device=dev), cam
    return (build_world_tables(world, dev), None), cam


@pytest.mark.parametrize("backend", ["bvh", "dense"])
@pytest.mark.parametrize("kind", ["tile", "sample", "2d"])
def test_captured_sharded_steps_bit_equal_to_eager(nccl_world, kind,
                                                   backend):
    """3 frames (int frame counts, a new jitter tensor each) of each
    sharded step, captured (one graph, the all-reduce recorded in it)
    against the same step eager: the accumulator bit for bit, the given
    one returned, one capture over all frames, and the kernels' launches
    of a call those of an eager step."""
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            EagerSteps)

    dev = torch.device("cuda")
    scene, cam = _shard_scene(backend, dev)
    eager = _sharded(kind, nccl_world, backend)
    graph = _sharded(kind, nccl_world, backend)
    eager.steps = EagerSteps()
    assert isinstance(graph.steps, CapturedSteps) and not graph.split
    acc_e = torch.zeros((RES * RES, 4), device=dev)
    acc_g = torch.zeros((RES * RES, 4), device=dev)
    for f in range(1, 4):
        jitter = torch.tensor([0.3 / RES, -0.2 / RES], device=dev) * f
        kernels.reset_launches()
        assert eager(scene, cam, f, jitter, acc_e) is acc_e
        counts = dict(kernels.launches)
        kernels.reset_launches()
        assert graph(scene, cam, f, jitter, acc_g) is acc_g
        assert kernels.launches == counts  # a capture's own not counted
        assert torch.equal(acc_e.view(torch.int32), acc_g.view(torch.int32))
    assert len(graph.steps.captures) == 1
    assert next(iter(graph.steps.entries.values())).launches == counts
    assert float(acc_g[:, 3].min()) == 3.0


def _one_device_frames(backend, scene, cam, spp, depth, frames):
    """`get_tracer(backend)` + `accumulate` over frames 1..frames at jitter
    0 on the card: the accumulator after each frame."""
    from webgpu_raytracer_tpu_torch.ops.api import get_tracer
    from webgpu_raytracer_tpu_torch.ops.trace import accumulate

    jitter = torch.zeros(2, device=cam.device)
    acc = torch.zeros((RES * RES, 4), device=cam.device)
    return [accumulate(acc, get_tracer(backend)(scene, cam, f, jitter, RES,
                                                 RES, spp, depth), f).clone()
            for f in range(1, frames + 1)]


@pytest.mark.parametrize("backend", ["bvh", "dense"])
@pytest.mark.parametrize("kind", ["tile", "sample", "2d"])
def test_sharded_steps_equal_the_one_device_frame_on_card(nccl_world, kind,
                                                          backend):
    """3 frames (jitter 0) of each sharded step, eager, on a world of one
    against `get_tracer(backend)` + `accumulate`: the tile step (spp 1)
    bit for bit, the sample and 2-D steps (spp 2) within 2e-5; a step
    launches the tracer's kernels at its spp, and one all-reduce where it
    reduces. (The captured steps equal the eager ones bit for bit:
    `test_captured_sharded_steps_bit_equal_to_eager`.)"""
    from webgpu_raytracer_tpu_torch.render.renderer import EagerSteps

    dev = torch.device("cuda")
    spp = 1 if kind == "tile" else 2
    scene, cam = _shard_scene(backend, dev)
    ref = _one_device_frames(backend, scene, cam, spp, 3, 3)
    step = _sharded(kind, nccl_world, backend, spp=spp)
    step.steps = EagerSteps()
    want = ({"bvh_closest": 3 * spp, "bvh_shadow": 3 * spp,
             "bvh_walk": 6 * spp, "bvh_shade": 3 * spp} if backend == "bvh"
            else {"dense_sweep": 4 * spp, "shade_rows": 3 * spp})
    if kind != "tile":
        want["all_reduce"] = 1
    acc = torch.zeros((RES * RES, 4), device=dev)
    jitter = torch.zeros(2, device=dev)
    for f in range(1, 4):
        kernels.reset_launches()
        assert step(scene, cam, f, jitter, acc) is acc
        assert _launched() == want
        if kind == "tile":
            assert torch.equal(acc.view(torch.int32),
                               ref[f - 1].view(torch.int32)), f
        else:
            assert torch.allclose(acc, ref[f - 1], rtol=2e-5, atol=2e-5), f


REPEAT_CAPTURES = 25  # fresh captured steps per kind and backend


@pytest.mark.parametrize("backend", ["bvh", "dense"])
@pytest.mark.parametrize("kind", ["tile", "sample", "2d"])
def test_repeated_sharded_captures_all_succeed(nccl_world, kind, backend):
    """REPEAT_CAPTURES fresh captured steps of one kind and backend, each
    capturing once (frame 1, jitter 0): every capture succeeds, and every
    replayed accumulator is the eager step's bit for bit. A capture that
    fails raises (there is no eager fallback); the count of such failures
    is in the assertion's message."""
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            EagerSteps)

    dev = torch.device("cuda")
    scene, cam = _shard_scene(backend, dev)
    jitter = torch.zeros(2, device=dev)
    eager = _sharded(kind, nccl_world, backend)
    eager.steps = EagerSteps()
    want = torch.zeros((RES * RES, 4), device=dev)
    eager(scene, cam, 1, jitter, want)
    failures = []
    for i in range(REPEAT_CAPTURES):
        step = _sharded(kind, nccl_world, backend)
        assert isinstance(step.steps, CapturedSteps)
        acc = torch.zeros((RES * RES, 4), device=dev)
        try:
            step(scene, cam, 1, jitter, acc)
            torch.cuda.synchronize()
        except RuntimeError as e:  # torch.AcceleratorError among them
            failures.append(f"{i}: {type(e).__name__}: {e}"[:200])
            continue
        assert len(step.steps.captures) == 1
        assert torch.equal(acc.view(torch.int32), want.view(torch.int32)), i
    assert not failures, (f"{len(failures)} of {REPEAT_CAPTURES} captures "
                          f"failed: {failures}")


def test_second_sharded_step_of_one_signature_gets_its_own_graph(
        nccl_world):
    """Two sample steps of one signature on one cache: two captures, and
    each replays its own graph (equal to its eager frames)."""
    from webgpu_raytracer_tpu_torch.render.renderer import (CapturedSteps,
                                                            EagerSteps)

    dev = torch.device("cuda")
    scene, cam = _shard_scene("bvh", dev)
    a, b, eager = (_sharded("sample", nccl_world, "bvh") for _ in range(3))
    eager.steps = EagerSteps()
    a.steps = b.steps = CapturedSteps(dev)
    accs = [torch.zeros((RES * RES, 4), device=dev) for _ in range(3)]
    jitter = torch.zeros(2, device=dev)
    for f in (1, 2):
        for step, acc in zip((a, b, eager), accs):
            step(scene, cam, f, jitter, acc)
        for acc in accs[:2]:
            assert torch.equal(acc.view(torch.int32),
                               accs[2].view(torch.int32))
    assert len(a.steps.captures) == 2


def test_capture_of_a_host_sync_in_a_sharded_step_raises(nccl_world,
                                                         monkeypatch):
    """A tracer that reads a device value on the host cannot be captured:
    the sharded step raises and stays captured (no eager fallback); the
    same step with the real tracer then captures."""
    from webgpu_raytracer_tpu_torch.parallel import sharding
    from webgpu_raytracer_tpu_torch.render.renderer import CapturedSteps

    dev = torch.device("cuda")
    scene, cam = _shard_scene("bvh", dev)
    real = sharding.get_tracer

    def syncing(backend):
        def tracer(*args, **kwargs):
            col, rays = real(backend)(*args, **kwargs)
            return col * float(col.sum()), rays
        return tracer

    step = _sharded("sample", nccl_world, "bvh")
    acc = torch.zeros((RES * RES, 4), device=dev)
    jitter = torch.zeros(2, device=dev)
    monkeypatch.setattr(sharding, "get_tracer", syncing)
    with pytest.raises(RuntimeError):
        step(scene, cam, 1, jitter, acc)
    assert isinstance(step.steps, CapturedSteps) and not step.steps.entries
    monkeypatch.setattr(sharding, "get_tracer", real)
    torch.cuda.synchronize()
    assert step(scene, cam, 1, jitter, acc) is acc
    assert len(step.steps.captures) == 1


def test_gloo_sharded_steps_on_one_card(cuda, tmp_path):
    """Two gloo ranks share the card, each in its own process
    (`tests/torch_gloo_card_rank.py`), and run the tile step (one graph)
    and the sample step (two graphs, gloo's all-reduce between them),
    captured frames bit-equal to eager ones in each rank. Their tile bands
    put together equal the one-device frame bit for bit, and their sample
    frames are the same on both ranks and within 2e-5 of it."""
    from webgpu_raytracer_tpu_torch.render.resources import \
        build_device_scene

    from tests import torch_gloo_card_rank as rank_script

    n = rank_script.FRAMES
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, rank_script.__file__, str(r), "2", str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    world = NativeWorld("cornell")
    world.update_camera(rank_script.RES, rank_script.RES)
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(cuda)
    scene = build_device_scene(world, device=cuda)
    ref = {spp: _one_device_frames("bvh", scene, cam, spp,
                                   rank_script.DEPTH, n)
           for spp in (1, rank_script.SPP)}
    for f in range(n):
        band = np.concatenate([r["band"][f] for r in ranks])
        np.testing.assert_array_equal(band.view(np.int32),
                                      ref[1][f].cpu().numpy().view(np.int32))
        for r in ranks:
            np.testing.assert_allclose(
                r["full"][f], ref[rank_script.SPP][f].cpu().numpy(),
                rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(ranks[0]["full"], ranks[1]["full"])
    for r in ranks:
        assert not r["band_split"] and r["full_split"]
        assert int(r["band_captures"]) == 1 and int(r["full_captures"]) == 2
