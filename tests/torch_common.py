"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the port compute on the same numbers.
"""

import numpy as np
import torch

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.render.worldtris import build_world_tris
from webgpu_raytracer_tpu_torch.ops.dense_trace import bounce_rays
from webgpu_raytracer_tpu_torch.render.worldtris import (build_world_tables,
                                                         tables_from_jax)

from tests.test_two_level import _rays

# The suite runs in several pytest-xdist workers, each of which imports
# this module while collecting. ATen's OpenMP pool (a thread per core in
# every worker) then oversubscribes the host, and its small ops ran up to
# 50x slower. One intra-op thread per worker.
torch.set_num_threads(1)


def jax_and_port_tables(scene_name, res=32, glb_data=None):
    """(world, JAX WorldTris, port WorldTables on the CPU) of one scene."""
    world = NativeWorld(scene_name, glb_data=glb_data)
    world.update_camera(res, res)
    wt = build_world_tris(world)
    tables = tables_from_jax({k: np.asarray(v)
                              for k, v in wt._asdict().items()})
    return world, wt, tables


def camera_rays(world, res):
    """Pixel-center primary rays (ro, rd), each (R, 3) f32."""
    c = np.asarray(world.camera(), np.float32)
    lane = np.arange(res * res)
    u = ((lane % res).astype(np.float32) + 0.5) / res
    v = 1.0 - ((lane // res).astype(np.float32) + 0.5) / res
    rd = np.stack([c[4 + k] + u * c[8 + k] + v * c[12 + k] - c[k]
                   for k in range(3)], 1).astype(np.float32)
    ro = np.broadcast_to(c[:3], rd.shape).astype(np.float32)
    return ro, rd


def random_rays(R, seed=3):
    """Rays from inside the unit box in random directions, with every 5th
    lane inactive and every 3rd given a finite t_max (as
    tests/test_pallas_interpret.py draws them)."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.9, 0.9, size=(R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    active = np.arange(R) % 5 != 0
    tmax = np.where(np.arange(R) % 3 == 0, 1.5, 1e30).astype(np.float32)
    return ro, rd, active, tmax


def rays8_np(ro, rd, tmax):
    """The (8, R) ray stack [d, o, t_max, 0] as a CPU tensor."""
    R = ro.shape[0]
    out = np.zeros((8, R), np.float32)
    out[0:3] = rd.T
    out[3:6] = ro.T
    out[6] = tmax
    return torch.from_numpy(out)


def assert_near_ties(shade_table, ro, rd, idx_a, idx_b, lanes):
    """Winners that differ on `lanes` must be f64 Moller-Trumbore near-ties
    (the check of tests/test_pallas_interpret.py)."""
    if lanes.size == 0:
        return
    st = np.asarray(shade_table, np.float64)
    v0, e1, e2 = st[:, 0:3], st[:, 3:6], st[:, 6:9]
    ron = np.asarray(ro, np.float64)[lanes]
    rdn = np.asarray(rd, np.float64)[lanes]

    def mt_t(tris):
        s = ron - v0[tris]
        h = np.cross(rdn, e2[tris])
        a = np.einsum("ij,ij->i", e1[tris], h)
        q = np.cross(s, e1[tris])
        return np.einsum("ij,ij->i", e2[tris], q) / a

    np.testing.assert_allclose(mt_t(idx_b[lanes]), mt_t(idx_a[lanes]),
                               rtol=2e-3, atol=2e-4,
                               err_msg="non-tie winner flip")


def png_bytes(px, color_type, filters=(0,), palette=None, depth=8,
              interlace=0):
    """A PNG of (H, W, C) u8 samples, row y written with row filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth):
    filtered rows the encoders in the tests do not choose themselves.
    `depth` and `interlace` only label the header."""
    import struct
    import zlib

    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int64)
    zero = np.zeros(c, np.int64)
    prior = np.zeros(w * c, np.int64)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([zero, cur[:-c]])
        upleft = np.concatenate([zero, prior[:-c]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + chunk(b"IEND", b"")


def np_rays(ro, rd, act, tmax):
    """JAX-fixture rays as numpy: (ro (3, R), rd (3, R), t_max (R,) with 0
    on inactive lanes)."""
    ro = np.stack([np.asarray(c, np.float32) for c in ro])
    rd = np.stack([np.asarray(c, np.float32) for c in rd])
    t = np.where(np.asarray(act), np.asarray(tmax, np.float32), 0.0)
    return ro, rd, t.astype(np.float32)


def stack8(ro, rd, t_max):
    """The (8, R) ray stack [d, o, t_max, 0] of (3, R) arrays, on the CPU."""
    return torch.from_numpy(np.concatenate(
        [rd, ro, t_max[None], np.zeros((1, t_max.size), np.float32)]))


def bounce_case(name, res=16):
    """(port tables on the CPU, ro (3, 2R), rd, t_max, R): the fused ray
    stack of bounce 1 at res^2 (R NEE shadow lanes, then R extension
    lanes), advanced through the port's plain path."""
    world = NativeWorld(name)
    world.update_camera(res, res)
    tables = build_world_tables(world, "cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    rays8 = bounce_rays(tables, cam, res, res, 1, 8).numpy()
    return tables, rays8[3:6], rays8[0:3], rays8[6], res * res


def job_cases(grid_wt, ladder_world, drain_world):
    """The job-stream path's fixtures: name -> (port tables, ro (3, R),
    rd (3, R), t_max (R,), split lane). tests/test_two_level.py's grid
    (random rays), ladder and drain worlds, and the bounce-1 stacks of
    mixed (35 tiles) and spheres (2,009 tiles) at 16^2."""
    def port(wt):
        return tables_from_jax({k: np.asarray(v)
                                for k, v in wt._asdict().items()})

    ro, rd, act, tmax = _rays(2000)
    out = {"grid": (port(grid_wt), *np_rays(ro, rd, act, tmax), 1000)}
    wt, ro, rd, act, tmax = ladder_world
    out["ladder"] = (port(wt), *np_rays(ro, rd, act, tmax), 384)
    wt, ro, rd, act, tmax = drain_world
    out["drain"] = (port(wt), *np_rays(ro, rd, act, tmax), 1280)
    for name in ("mixed", "spheres"):
        out[name] = bounce_case(name)
    return out


def scaled_case(case_rays):
    """A `job_cases` entry with |d| ~ 10 (primary rays are not unit length)
    and t_max cut to a tenth, every 5th lane's to a hundredth."""
    tables, ro, rd, t_max, split = case_rays
    lane = np.arange(t_max.size)
    t = np.where(lane % 5 == 1, t_max * 0.01, t_max * 0.1)
    return tables, ro, rd * 10.0, t.astype(np.float32), split
