"""The benchmark's `textured-seeded` cell on the CPU: its model, the port
against the benchmark's plain reference on it, planted faults, and the
cell's three new per-layer readers.

The model (`portbench/scenes/tex_instances.py`) is 16 textured UV spheres,
each turned its own way, and a textured emitter in the viewer room, five
1024^2 layers: a multi-tile scene (the job narrow phase) whose every
bounce samples level 0. The port's frames seeded from the G-buffer are
held to the reference (`portbench/reference/pathtrace.py`, plain PyTorch
that imports nothing of the port) bit for bit, and to the port's own
traced frames. Short windows of the cell at 32x24 (the cell's depth,
check and limits otherwise) come out not correct when a fault is planted
in the program, and correct without one.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from portbench.lib import spec
from portbench.lib.profile import Op, Trace
from portbench.lib.window import Window
from portbench.reference import pathtrace as pt
from portbench.run import run_cell
from webgpu_raytracer_tpu_torch import NativeWorld
from webgpu_raytracer_tpu_torch.ops.api import DENSE_MAX_TRIS
from webgpu_raytracer_tpu_torch.ops.cuda_dense import multi_tile
from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
from webgpu_raytracer_tpu_torch.ops.gbuffer import render_gbuffer
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables
from webgpu_raytracer_tpu_torch.utils import profiling
from webgpu_raytracer_tpu_torch.utils.halton import frame_jitter
from webgpu_raytracer_tpu_torch.utils.textures import (build_quad_pyramid,
                                                       decode_world_textures)

BENCH = spec.Spec()
CELL = "textured-seeded"
W, H = 32, 24
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))


@pytest.fixture(scope="module")
def model():
    """(GLB bytes, the world at W x H, the port's tables and pyramid)."""
    glb = spec.scene("tex_instances").glb()
    world = NativeWorld("viewer", glb_data=glb)
    world.update_camera(W, H)
    tables = build_world_tables(world, "cpu")
    decoded = decode_world_textures(world)
    return glb, world, tables, decoded


@pytest.mark.parametrize("aspect", ["bytes", "instances", "layers",
                                    "triangles"])
def test_model(model, aspect):
    """The same bytes on every call; 16 + 1 model instances, each of a
    mesh of its own (the viewer gives every model instance one transform,
    so each sphere carries its placement); five 1024^2 layers (level 1 is
    level 0); 8,462 world triangles, multi-tile and under the CPU's dense
    limit, so the CPU takes the card's path."""
    glb, world, tables, decoded = model
    if aspect == "bytes":
        assert spec.scene("tex_instances").glb() == glb
    elif aspect == "instances":
        inst = np.asarray(world.instances(), np.float32).reshape(-1, 36)[1:]
        geoms = inst[:, 32:36].copy().view(np.uint32)[:, 2]
        assert inst.shape[0] == 17 and len(set(geoms.tolist())) == 17
        topo = np.asarray(world.topology(), np.uint32).reshape(-1, 20)
        per_geom = np.bincount(topo[:, 3].astype(np.int64))
        assert sorted(per_geom[geoms].tolist()) == [2] + [528] * 16
    elif aspect == "layers":
        assert decoded.shape == (5, 1024, 1024, 3)
        l0, l1 = build_quad_pyramid(decoded)
        assert l1 is l0
        assert tables.tex_slots == (True, True, True, True)
        assert tables.light_tex
    else:
        valid = int(tables.valid_count)
        assert valid == 16 * 528 + 2 + 12
        assert 128 < valid <= DENSE_MAX_TRIS
        assert multi_tile(tables)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_seeded_frame_is_the_references(model, depth):
    """Frames 1 and 987,654 of the model seeded from the G-buffer through
    the port's plain versions (the job narrow phase), against the
    reference at every pixel, bit for bit, with the ray count, and against
    the port's own traced frame: every slot on curved, rotated, scaled
    triangles, the textured emitter hit and sampled."""
    glb, world, tables, decoded = model
    tex = device_pyramid(build_quad_pyramid(decoded), "cpu")
    arrays = {k: np.array(getattr(world, k)()) for k in
              ("topology", "vertices", "normals", "uvs", "instances",
               "lights")}
    arrays["textures"] = [world.texture(i)
                          for i in range(world.texture_count())]
    camera = np.asarray(world.camera(), np.float32)
    assert camera[3] == 0.0  # lens radius 0: seeded and traced agree
    scene = pt.Scene(pt.world_tables(arrays), "cpu")
    cam = torch.from_numpy(camera)
    for frame in (1, 987654):
        jitter = torch.from_numpy(frame_jitter(frame, W, H))
        gb = render_gbuffer(tables, tex, cam, W, H, jitter=jitter)
        seeded, rays = trace_pixels_dense(
            tables, cam, frame, jitter, W, H, 1, depth, with_stats=True,
            textures=tex, seed_wt_idx=gb.wt_idx.reshape(-1))
        traced, traced_rays = trace_pixels_dense(
            tables, cam, frame, jitter, W, H, 1, depth, with_stats=True,
            textures=tex)
        ref, ref_rays = pt.radiance(scene, camera, torch.arange(W * H),
                                    frame, W, H, depth)
        assert torch.equal(seeded, ref)
        assert torch.equal(traced.view(torch.int32),
                           seeded.view(torch.int32))
        assert int(ref_rays.sum()) == int(traced_rays) == int(rays) + W * H
        assert float(ref.mean()) > 0.0


def _rotation_dropped():
    """The first sphere's instance without its rotation (the viewer's half
    turn about +y; its scale kept) in the program's tables."""
    from webgpu_raytracer_tpu_torch.render import renderer
    real = renderer.build_world_tables

    class Unturned:
        def __init__(self, world):
            self.world = world

        def __getattr__(self, name):
            return getattr(self.world, name)

        def instances(self):
            inst = np.array(self.world.instances(), np.float32) \
                .reshape(-1, 36)
            scale = float(np.linalg.norm(inst[1, 0:3]))
            inst[1, 0:16] = np.diag([scale] * 3 + [1.0]).ravel()
            inst[1, 16:32] = np.diag([1 / scale] * 3 + [1.0]).ravel()
            return inst.ravel()

    def build(world, device):
        return real(Unturned(world), device)

    return renderer, "build_world_tables", build


def _mip_past_first_bounce():
    """Bounces past the first sample the 128^2 box mip, which the port
    keeps only for scenes of at most four layers."""
    from webgpu_raytracer_tpu_torch.utils import textures
    return textures, "KRON_MAX_ROWS", 1 << 30


FAULTS = {"an_instance_rotation_dropped": _rotation_dropped,
          "the_mip_past_the_first_bounce": _mip_past_first_bounce,
          "none": None}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    """A short window of the cell with each fault planted, and with none
    (then correct, the plain versions agreeing with the reference bit for
    bit): two warm-up frames in place of the traffic's 17, which only
    capture graphs on the card."""
    if FAULTS[fault]:
        monkeypatch.setattr(*FAULTS[fault]())
    over = dict(width=W, height=H, check_within=2, check_frames=2,
                frames_before_window=2)
    res = run_cell(BENCH, CELL, 2026101927, 1.0 * WORKERS, False,
                   device="cpu", t_start=time.perf_counter(),
                   overrides=over)
    parted = res["checks"]["parted_pct"]
    if FAULTS[fault] is None:
        assert res["correct"], res["checks"]
        assert res["checks"]["drift_pct"]["value"] == 0.0, res["checks"]
    else:
        assert not res["correct"], res["checks"]
        assert parted["value"] > parted["limit"], res["checks"]


# -- the cell's new per-layer readers -----------------------------------------

def _read(name, trace=None, window=None):
    return BENCH.reader("per_layer", name).read(trace, window)


def _trace(ops, **kw):
    args = dict(frames=2, presents=2, rays=0.0, launches={})
    args.update(kw)
    return Trace(ops=[Op(*o) for o in ops], spans=[], t0=0.0, t1=1.0, **args)


def _frame(launch, before_ms, fetch=True):
    """A frame step's graph: a fill launched on its own, the G-buffer's
    ops, then (seeded) the seed-row fetch and a bounce's shade."""
    t, out = launch + 0.001, [("fill", launch, launch + 1e-6, launch - 1e-4,
                               "render_frame")]
    for ms in before_ms:
        out.append(("void job_sweep_kernel<true>(...)", t, t + ms * 1e-3,
                    launch, "render_frame"))
        t += ms * 1e-3
    if fetch:
        out.append(("void fetch_rows_t_kernel(...)", t, t + 1e-4, launch,
                    "render_frame"))
    out.append(("void shade_rows_kernel<true>(...)", t + 2e-4, t + 5e-4,
                launch, "render_frame"))
    return out


def _window():
    return Window(setup_s=1.0, t_open=0.0, ends=[1.0], rays=0.0,
                  pixels=1920 * 1080, tris=8462, light_rows=4)


def _gbuffer_ms(seeded: bool):
    """Two frame steps of 2.0 and 3.0 ms before the fetch, or a traced
    frame with no fetch."""
    if not seeded:
        return _trace(_frame(0.1, [0.5], fetch=False)), None
    return _trace(_frame(0.1, [0.5, 1.5]) + _frame(0.3, [1.0, 2.0])), 2.5


def _roofline(launched: bool):
    """A stretch whose textured shade took twice its least time (the
    white-texel shade beside it is not read), or launched none."""
    roof = spec.roofline("shade_rows_tex")
    n = 16 if launched else 0
    rays = 2 * 1920 * 1080 + 2 * 6e6
    live = (rays - 2 * 1920 * 1080) / 2
    least = (live * (roof.LANE_BYTES + roof.QUADS * roof.QUAD_BYTES)
             + n * 4 * roof.ROW_BYTES) / 3.35e12
    ops = [("void shade_rows_kernel<true>(...)", 0.0, 2 * least, 0.0,
            "render_frame"),
           ("void shade_rows_kernel<false>(...)", 0.5, 0.6, 0.4,
            "render_frame")]
    trace = _trace(ops, rays=rays,
                   launches={"shade_rows_tex": n} if n else {})
    return trace, 50.0 if launched else None


CASES = {"gbuffer_ms": ("gbuffer_ms", _gbuffer_ms, True),
         "gbuffer_ms_traced": ("gbuffer_ms", _gbuffer_ms, False),
         "shade_rows_tex_roofline": ("shade_rows_tex_roofline", _roofline,
                                     True),
         "shade_rows_tex_roofline_none": ("shade_rows_tex_roofline",
                                          _roofline, False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_new_reader_reads_its_known_value(case):
    name, make, arg = CASES[case]
    trace, want = make(arg)
    got = _read(name, trace, _window())
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("counted", [True, False])
def test_texture_load_ms_reads_the_programs_counter(counted, monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    if counted:
        profiling.count("texture_load_ms", 1234.5)
        profiling.count("texture_load_ms", 0.5)
    got = _read("texture_load_ms")
    assert got == (1235.0 if counted else None)
