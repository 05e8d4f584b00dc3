"""A configuration that loads a textured model (`"model"`, `scenes/`), on
the CPU and on the card.

The models are `scenes/tex_mip.py` (four layers: bounces past the first
sample the 128^2 box mip) and `scenes/tex_full.py` (five layers: level 0
everywhere), each a metal box that binds all four texture slots, a
Lambertian box and a textured emitter in the viewer room. Whole runs of
`cornell-interactive` (and of `cornell-record`) at a tiny size with the
model, traced or seeded from the G-buffer, come out correct; the bfloat16
control and each fault a textured frame can have come out not correct.
The reference's layers are the port's decoded layers bit for bit, and its
radiance the port's plain tracer's at every pixel. Untextured scenes'
tables are as they were: no UVs, no textures.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.lib import check, drivers, gltf, spec
from portbench.reference import pathtrace as pt
from portbench.reference import textures
from portbench.run import run_cell

BENCH = spec.Spec()
MODELS = ("tex_mip", "tex_full")
TINY = dict(scene="viewer", width=32, height=24, max_depth=3)
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
SEEDED = {"render_args": {"use_gbuffer": True}}


class _Stop(Exception):
    """Raised by a recording stand-in once it has what it came for."""


def _run(model="tex_mip", seed=20261019, extra=None, workload=
         "cornell-interactive", seconds=1.0) -> dict:
    over = dict(TINY, model=model, check_within=2, check_frames=2, spp=4,
                check_samples=2, **(extra or {}))
    return run_cell(BENCH, workload, seed, seconds * WORKERS, False,
                    device="cpu", t_start=time.perf_counter(),
                    overrides=over)


def _arrays(model: str, width=32, height=24) -> dict:
    return check.scene_arrays("viewer", width, height, 0.0,
                              glb_data=spec.scene(model).glb())


# -- the scenes and the reference's layers ------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_scene_is_the_same_bytes_on_every_call(model):
    a, b = spec.scene(model).glb(), spec.scene(model).glb()
    assert a == b


@pytest.mark.parametrize("model,count", [("tex_mip", 4), ("tex_full", 5)])
def test_reference_layers_equal_the_programs(model, count):
    """Level 0 as the port's `decode_world_textures` gives it, and level 1
    as its `build_quad_pyramid` packs it, bit for bit."""
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.utils.textures import (
        build_quad_pyramid, decode_world_textures)

    world = NativeWorld("viewer", glb_data=spec.scene(model).glb())
    decoded = decode_world_textures(world)
    images = [world.texture(i) for i in range(world.texture_count())]
    mine = textures.values(textures.codes(images))
    assert mine.shape == (count, 1024, 1024, 3)
    assert np.array_equal(mine.view(np.uint32), decoded.view(np.uint32))
    l0, l1 = build_quad_pyramid(decoded)
    r0, r1 = textures.levels(images)
    for theirs, ours in ((l0, r0), (l1, r1)):
        c = ours.astype(np.uint32)
        words = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        assert np.array_equal(theirs[..., 0], words)  # corner (y, x)
    assert (r1 is r0) == (count > 4)
    assert r1.shape[1] == (1024 if count > 4 else 128)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_reference_agrees_with_the_program_on_a_textured_scene(model, depth):
    """Frames of the model through the port's plain tracer against the
    reference at every pixel, bit for bit, with the ray count: every slot,
    the textured emitter hit and sampled, both levels."""
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
    from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
    from webgpu_raytracer_tpu_torch.render.worldtris import \
        build_world_tables
    from webgpu_raytracer_tpu_torch.utils.halton import frame_jitter
    from webgpu_raytracer_tpu_torch.utils.textures import (
        build_quad_pyramid, decode_world_textures)

    W, H = 32, 24
    world = NativeWorld("viewer", glb_data=spec.scene(model).glb())
    world.update_camera(W, H)
    tables = build_world_tables(world, "cpu")
    assert tables.tex_slots == (True, True, True, True) and tables.light_tex
    tex = device_pyramid(build_quad_pyramid(decode_world_textures(world)),
                         "cpu")
    arr = _arrays(model, W, H)
    scene = pt.Scene(pt.world_tables(arr), "cpu")
    for frame in (1, 987654):
        col, rays = trace_pixels_dense(
            tables, torch.from_numpy(arr["camera"]), frame,
            torch.from_numpy(frame_jitter(frame, W, H)), W, H, 1, depth,
            with_stats=True, textures=tex)
        ref, ref_rays = pt.radiance(scene, arr["camera"],
                                    torch.arange(W * H), frame, W, H, depth)
        assert torch.equal(ref, col)
        assert int(ref_rays.sum()) == int(rays)


def _tables_equal(a: dict, b: dict) -> bool:
    return all(
        (a[k] is None and b[k] is None) if k == "textures"
        else np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        for k in a)


@pytest.mark.parametrize("scene", ["cornell", "spheres"])
def test_untextured_tables_are_as_they_were(scene):
    """A scene that binds no texture reads neither its UVs nor images:
    its tables come out the same without them, with UV columns 0 and no
    texture levels."""
    arr = check.scene_arrays(scene, 16, 16, 0.0)
    assert arr["textures"] == []
    tables = pt.world_tables(arr)
    bare = pt.world_tables({k: v for k, v in arr.items()
                            if k not in ("uvs", "textures")})
    assert _tables_equal(tables, bare)
    assert tables["textures"] is None
    assert not tables["shade"][:, 18:24].any()
    assert tables["shade"].shape == (36 if scene == "cornell" else 257136,
                                     40)


def _grey_png(side: int) -> bytes:
    """An 8-bit greyscale PNG (colour type 0) of zeros."""
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", side, side, 8, 0, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(bytes(side * (side + 1))))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("bad", ["jpeg", "small", "grey", "truncated",
                                 "none"])
def test_reference_raises_on_a_layer_it_does_not_restate(bad):
    img = np.zeros((1024, 1024, 3), np.uint8)
    data = {"jpeg": b"\xff\xd8\xff\xe0" + bytes(64),
            "small": gltf.png(img[:512, :512]),
            "grey": _grey_png(1024),
            "truncated": gltf.png(img)[:40],
            "none": b"no image"}[bad]
    with pytest.raises(ValueError, match="texture 1"):
        textures.levels([gltf.png(img), data])


# -- the construction sites ---------------------------------------------------

def _record_builds(monkeypatch) -> list:
    """Stand-ins for the program's `Renderer` and `NativeWorld` that record
    what each call was given, then stop the caller."""
    import webgpu_raytracer_tpu_torch as program

    calls = []

    def recorder(*a, **kw):
        calls.append((a, kw))
        raise _Stop

    monkeypatch.setattr(program, "Renderer", recorder)
    monkeypatch.setattr(program, "NativeWorld", recorder)
    return calls


def _build(site: str, cfg: dict) -> None:
    cell = BENCH.workload({"sharded": "cornell1080-sample4",
                           "record": "cornell-record"}.get(
                               site, "cornell-interactive"))
    traffic = BENCH.traffic(cell["traffic"])
    if site == "sharded":
        from portbench.loops import sharded
        sharded._scene(cfg, "cpu")
    elif site == "check":
        snap = dict(time=0.0)
        check.check(SimpleNamespace(snapshots=[snap]), cfg, "cpu")
    else:
        BENCH.loop(cell["traffic"]).run(
            cfg, traffic, 1, 1.0, False, "cpu",
            drivers.Phases(time.perf_counter()), spec.kernel_patterns())


@pytest.mark.parametrize("site", ["interactive", "record", "sharded",
                                  "check"])
@pytest.mark.parametrize("model", [None, "tex_mip"])
def test_every_construction_site_builds_the_configurations_scene(
        site, model, monkeypatch):
    """The three loops and the check build the scene from the preset and,
    with a `"model"`, from the same GLB bytes; without one, from the
    preset alone, as before."""
    calls = _record_builds(monkeypatch)
    cfg = dict(BENCH.config("cornell_720x480_d10"), scene="viewer")
    if model:
        cfg["model"] = model
    with pytest.raises(_Stop):
        _build(site, cfg)
    (args, kw), = calls
    assert args[0] == "viewer"
    if model:
        assert kw["glb_data"] == spec.scene(model).glb()
    else:
        assert "glb_data" not in kw


# -- whole runs ---------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("seeded", [False, True])
def test_textured_run_is_correct(model, seeded):
    res = _run(model, extra=SEEDED if seeded else None)
    assert res["correct"], res["checks"]
    assert res["checks"]["drift_pct"]["value"] == 0.0, res["checks"]


def test_textured_record_run_is_correct():
    res = _run("tex_mip", workload="cornell-record", seconds=1.5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("model", MODELS)
def test_textured_control_is_not_correct(model):
    """The reference in bfloat16, in the program's place."""
    cell = BENCH.workload("cornell-interactive")
    over = dict(TINY, model=model, check_within=2, check_frames=2)
    cfg = dict(BENCH.config(cell["config"]), **over)
    traffic = dict(BENCH.traffic(cell["traffic"]), **over)
    window = BENCH.loop(cell["traffic"]).run(
        cfg, traffic, 31337, 1.0 * WORKERS, False, "cpu",
        drivers.Phases(time.perf_counter()), spec.kernel_patterns())
    numbers, _ = check.check(window, cfg, "cpu", control=True)
    limits = BENCH.limits("cornell-interactive")
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def _layer_swapped():
    from webgpu_raytracer_tpu_torch.render import renderer
    real = renderer.decode_world_textures

    def decode(world, *a, **kw):
        layers = real(world, *a, **kw)
        return np.concatenate([layers[1:2], layers[0:1], layers[2:]])

    return renderer, "decode_world_textures", decode


def _uvs_zeroed():
    from webgpu_raytracer_tpu_torch.render import renderer
    real = renderer.build_world_tables

    def build(world, device):
        t = real(world, device)
        shade, lights = t.shade_table.clone(), t.light_rows.clone()
        shade[:, 18:24] = 0.0
        lights[:, 18:24] = 0.0
        return t._replace(shade_table=shade, light_rows=lights)

    return renderer, "build_world_tables", build


def _gbuffer_rays_left_out():
    from webgpu_raytracer_tpu_torch.render import renderer
    real = renderer.render_step

    def step(*a, width, height, use_gbuffer=False, **kw):
        out, rays = real(*a, width=width, height=height,
                         use_gbuffer=use_gbuffer, **kw)
        return out, rays - (width * height if use_gbuffer else 0)

    return renderer, "render_step", step


FAULTS = {"a_texture_layer_swapped": _layer_swapped,
          "the_uvs_zeroed": _uvs_zeroed,
          "the_gbuffers_rays_left_out": _gbuffer_rays_left_out}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_textured_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(*FAULTS[fault]())
    res = _run("tex_mip", seed=4242, extra=SEEDED)
    assert not res["correct"], res["checks"]


def test_seeded_frame_under_a_lens_raises(monkeypatch):
    """The check compares a seeded frame with the traced one only at lens
    radius 0, where the two are the same bits."""
    real = check.scene_arrays

    def lens(*a, **kw):
        out = real(*a, **kw)
        out["camera"][3] = 0.01
        return out

    monkeypatch.setattr(check, "scene_arrays", lens)
    cfg = dict(BENCH.config("cornell_720x480_d10"), **TINY)
    snap = dict(time=0.0, gbuffer=True)
    with pytest.raises(ValueError, match="lens"):
        check.check(SimpleNamespace(snapshots=[snap]), cfg, "cpu")


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_seeded_textured_run_is_correct_on_the_card(model):
    """The interactive loop and the check on the textured viewer scene at
    160x120, depth 4, seeded from the G-buffer: the frames go through
    `fetch_rows.cu` (the seed rows), `fetch_quad` (the G-buffer's texels)
    and the textured shade kernel. No textured cell has limits of its own
    yet: the window is held to cornell-interactive's, or, where the
    textured kernel rounds past them (`drift_pct` counts pixels off by
    more than rtol 1e-5 along the same path; level-0 texels at every bounce
    turn a rounding of the UVs into one of the colour), each number to a
    tenth of the bfloat16 control's reading. Prints both readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from webgpu_raytracer_tpu_torch import kernels
    cell = BENCH.workload("cornell-interactive")
    over = dict(TINY, width=160, height=120, max_depth=4, model=model,
                **SEEDED)
    cfg = dict(BENCH.config(cell["config"]), **over)
    traffic = dict(BENCH.traffic(cell["traffic"]), **over)
    before = dict(kernels.launches)
    window = BENCH.loop(cell["traffic"]).run(
        cfg, traffic, 20261019, 3.0, False, "cuda",
        drivers.Phases(time.perf_counter()), spec.kernel_patterns())
    ran = {k: kernels.launches[k] - before.get(k, 0)
           for k in ("fetch_rows", "fetch_quad", "shade_rows")}
    numbers, _ = check.check(window, cfg, "cuda")
    control, _ = check.check(window, cfg, "cuda", control=True)
    print(f"textured {model} on the card: program {numbers} control "
          f"{control} launches {ran}")
    assert all(v > 0 for v in ran.values()), ran
    limits = BENCH.limits("cornell-interactive")
    if not all(v <= limits[k] for k, v in numbers.items()):
        assert all(v <= control[k] / 10 for k, v in numbers.items()
                   if control[k] > 0), (numbers, control)
