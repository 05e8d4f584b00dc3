"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip where no card
is present. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda

`python3 chip_smoke.py` runs the same checks at the full cornell 512^2
shapes; these use small frames.
"""

import numpy as np
import pytest
import torch

from webgpu_raytracer_tpu_torch import NativeWorld, Renderer, RenderConfig
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import cuda_dense, shade_rows
from webgpu_raytracer_tpu_torch.ops.dense import (T_MAX, closest_plain,
                                                  ray_stack, rows_plain,
                                                  shadow_plain)
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
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
    before = kernels.launches["dense_sweep"]
    t, idx, rows = cuda_dense.closest_with_row(tables, rays8, R // 2)
    occ = cuda_dense.shadow(tables, rays8)
    assert kernels.launches["dense_sweep"] == before + 2
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
    assert r.launches == {"dense_sweep": 2 * 6, "shade_rows": 2 * 5}
