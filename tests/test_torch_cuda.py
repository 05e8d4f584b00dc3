"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip where no card
is present. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda

`python3 chip_smoke.py` runs the same checks at the full 512^2 shapes
(cornell for the single-tile kernels, spheres for the job-stream and scan
paths); these use small frames.
"""

import numpy as np
import pytest
import torch

import chip_smoke

from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import (cuda_dense, cuda_fetch, cuda_jobs,
                                            cuda_scan, shade_rows)
from webgpu_raytracer_tpu_torch.ops.cluster_cull import (keys_plain,
                                                         worklists_plain)
from webgpu_raytracer_tpu_torch.ops.dense import (T_MAX, closest_plain,
                                                  jobs_closest_plain,
                                                  jobs_stats_plain,
                                                  ray_stack, rows_plain,
                                                  scan_closest_plain,
                                                  scan_shadow_plain,
                                                  shadow_plain, worklist_mask)
from webgpu_raytracer_tpu_torch.ops.coherence import coherence_sort
from webgpu_raytracer_tpu_torch.ops.dense_trace import (bounce_rays,
                                                        trace_pixels_dense)
from webgpu_raytracer_tpu_torch.ops.fetch import (fetch_quad_plain,
                                                  fetch_rows_plain)
from webgpu_raytracer_tpu_torch.ops.rng import init_rng
from webgpu_raytracer_tpu_torch.ops.v3 import V3
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables

pytestmark = pytest.mark.cuda
RES = 64


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


@pytest.mark.parametrize("depth", [0, 4])
def test_shade_kernel_matches_plain(cuda, depth):
    tables, ro, rd = _scene("cornell", cuda)
    R = RES * RES
    _, idx, rowT = cuda_dense.closest_with_row(tables, ray_stack(ro, rd,
                                                                 T_MAX))
    one, zero = torch.ones(R, device=cuda), torch.zeros(R, device=cuda)
    state = torch.stack([one, *ro, *rd, one, one, one, zero, zero, zero,
                         zero, one, zero, zero, zero, zero, one])
    args = (state, init_rng(torch.arange(R, device=cuda), 1), rowT, idx,
            tables.light_rows, depth, tables.light_count, 8)
    out, rng, rays8 = shade_rows.shade(*args)
    out_p, rng_p = shade_rows.shade_step(*args)
    assert torch.equal(rng, rng_p)
    assert torch.equal(rays8, shade_rows.next_rays(out))
    close = torch.isclose(out, out_p, rtol=1e-4, atol=1e-5).all(0)
    assert close.float().mean() >= 0.995


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
    r = Renderer("cornell", RenderConfig(width=RES, height=RES, max_depth=5),
                 device="cuda")
    for _ in range(2):
        r.render_frame()
        img = r.present()
    assert img.shape == (RES, RES, 3) and np.isfinite(r.radiance()).all()
    assert r.launches == {"dense_sweep": 2 * 6, "shade_rows": 2 * 5,
                          "fetch_rows": 0, "fetch_quad": 0,
                          "cluster_cull": 0, "job_sweep": 0,
                          "cluster_cull_keyed": 0, "scan_sweep": 0}


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
    per frame of depth 5, seeded from the G-buffer: 6 sweeps, 6 row fetches
    (5 light, 1 seed) and 6 quad fetches (G-buffer, seed, 4 extension
    hits)."""
    r = Renderer("viewer", RenderConfig(width=RES, height=RES, max_depth=5),
                 glb_data=chip_smoke.textured_quad_glb(), device="cuda")
    for _ in range(2):
        r.render_frame(use_gbuffer=True)
        img = r.present()
    assert img.shape == (RES, RES, 3) and np.isfinite(r.radiance()).all()
    assert r.launches == {"dense_sweep": 2 * 6, "shade_rows": 0,
                          "fetch_rows": 2 * 6, "fetch_quad": 2 * 6,
                          "cluster_cull": 0, "job_sweep": 0,
                          "cluster_cull_keyed": 0, "scan_sweep": 0}


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
    rays_s, perm = coherence_sort(rays8, tables.spheres, g, R)
    order, counts = cuda_jobs.worklists(tables.spheres, rays_s, g)
    return rays_s, perm, order, counts


@pytest.mark.parametrize("scene", ["mixed", "spheres"])
def test_cull_kernel_matches_plain(cuda, bounce_stacks, scene):
    tables, rays8, R = bounce_stacks[scene]
    g = 128
    rays_s, perm, order, counts = _sort_and_cull(tables, rays8, R)
    assert kernels.launches["cluster_cull"] > 0
    order_p, counts_p = worklists_plain(tables.spheres, rays_s, g)
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
    r = Renderer("spheres", RenderConfig(width=RES, height=RES, max_depth=3),
                 device="cuda")
    for _ in range(2):
        r.render_frame()
        img = r.present()
    assert img.shape == (RES, RES, 3) and np.isfinite(r.radiance()).all()
    assert r.launches == {"dense_sweep": 0, "cluster_cull": 2 * 4,
                          "job_sweep": 2 * 4, "shade_rows": 2 * 3,
                          "fetch_rows": 0, "fetch_quad": 0,
                          "cluster_cull_keyed": 0, "scan_sweep": 0}


# --- the scan path (narrow="scan") -------------------------------------------


@pytest.mark.parametrize("m", [512, 1024])
@pytest.mark.parametrize("scene", ["mixed", "spheres"])
def test_keyed_cull_kernel_matches_plain(cuda, bounce_stacks, scene, m):
    """Survivors equal and keys within 2 ulp (bit-equal where both take
    the correctly rounded root and quotient) of the plain keyed cull."""
    tables, rays8, R = bounce_stacks[scene]
    rays_s, _ = coherence_sort(rays8, tables.spheres, m, R)
    before = kernels.launches["cluster_cull_keyed"]
    keys = cuda_scan.cluster_keys(tables.spheres, rays_s, m)
    assert kernels.launches["cluster_cull_keyed"] == before + 1
    keys_p = keys_plain(tables.spheres, rays_s, m)
    assert torch.equal(keys < 3e38, keys_p < 3e38)
    ulps = (keys.view(torch.int32).long()
            - keys_p.view(torch.int32).long()).abs().max()
    assert int(ulps) <= 2, int(ulps)
    assert 0 < int((keys < 3e38).sum(1).max()) <= tables.spheres.shape[0]


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
    rays_s, perm = coherence_sort(rays8, tables.spheres, m, R)
    lists = cuda_scan.worklists_keyed(tables.spheres, rays_s, m, cull)
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
    r = Renderer("spheres", RenderConfig(**cfg), device="cuda",
                 narrow="scan")
    ref = Renderer("spheres", RenderConfig(**cfg), device="cuda")
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
                          "fetch_rows": 0, "fetch_quad": 0}


# --- the cooperative walk behind the queue of touching lanes -----------------


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _narrow_kernels_agree(tables, rays8, kernel):
    """One narrow-phase kernel (`"jobs"` at g = 128, `"scan"` at m = 1,024)
    on a whole stack: t, idx, rows and occlusion bit-equal to
    `dense_sweep.cu` walking every tile and to the plain versions, the same
    from a second launch (the queue's order varies), stats equal to the
    plain count. Returns (idx, stats, stats_any, block size)."""
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
        rays_s, perm = coherence_sort(rays8, tables.spheres, b, 0)
        lists = cuda_jobs.worklists(tables.spheres, rays_s, b)

        def sweep(any_hit, stats=False):
            return cuda_jobs.job_sweep(tables, rays_s, perm, *lists, b, R,
                                       any_hit, with_stats=stats)

        t_s, i_s = jobs_closest_plain(tables, rays_s, *lists, b)
        plain_stats = [jobs_stats_plain(tables, rays_s, *lists, b, a)
                       for a in (False, True)]
    else:
        b = 1024
        rays_s, perm = coherence_sort(rays8, tables.spheres, b, 0)
        lists = cuda_scan.worklists_keyed(tables.spheres, rays_s, b)

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
    assert torch.equal(stats.cpu(), plain_stats[0])
    assert torch.equal(stats_any.cpu(), plain_stats[1])
    return idx, stats, stats_any, b


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
    idx, stats, stats_any, b = _narrow_kernels_agree(tables, rays8, kernel)
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
    idx, stats, stats_any, _ = _narrow_kernels_agree(tables, rays8, kernel)
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
