"""The output check, driven through whole runs of the cells at a tiny size
on the CPU (the kernels' plain versions): sound runs come out correct, and
the control and every fault a cell can have come out not correct.

The harness's look for a card is skipped (`run_cell` with device="cpu");
the rest of a run is as on the card. Each fault breaks the timed path
underneath, where its answer is produced.
"""

from __future__ import annotations

import os
import time

import pytest
import torch

from portbench.lib import check, drivers, spec
from portbench.run import run_cell

BENCH = spec.Spec()
CELLS = [w["name"] for w in BENCH.data["workloads"] if w["chips"] == 1]
# Per scene: a tiny size, and a window long enough for the frames that
# the checks are drawn from (the spheres scene's plain path is slow), in
# one process that has the machine's cores to itself.
TINY = {"cornell": (dict(width=24, height=16, max_depth=3), 0.4),
        "spheres": (dict(width=8, height=6, max_depth=2), 1.5)}
# The windows are wall-clock time, and pytest-xdist's workers share the
# cores: under n workers a frame takes up to n times as long, so every
# window is n times as long, and still holds the frames it needs.
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))


def _tiny(workload: str) -> tuple:
    scene = BENCH.config(BENCH.workload(workload)["config"])["scene"]
    size, seconds = TINY[scene]
    return dict(size, check_within=2, check_frames=2, spp=4,
                check_samples=2), seconds * WORKERS


def _run(workload: str, seed: int = 20260417, extra=None,
         seconds=None) -> dict:
    over, tiny_s = _tiny(workload)
    over.update(extra or {})
    seconds = seconds * WORKERS if seconds else tiny_s
    return run_cell(BENCH, workload, seed, seconds, False, device="cpu",
                    t_start=time.perf_counter(), overrides=over)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(BENCH.limits(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in bfloat16, in the program's place."""
    cell = BENCH.workload(workload)
    over, seconds = _tiny(workload)
    cfg = dict(BENCH.config(cell["config"]), **over)
    traffic = dict(BENCH.traffic(cell["traffic"]), **over)
    window = BENCH.loop(cell["traffic"]).run(
        cfg, traffic, 31337, seconds, False, "cpu",
        drivers.Phases(time.perf_counter()), spec.kernel_patterns())
    numbers, _ = check.check(window, cfg, "cpu", control=True)
    limits = BENCH.limits(workload)
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("every", [1, 2, 3])
def test_interactive_loop_with_ticks_and_render_args_is_correct(every):
    """The interactive loop's optional traffic keys: a scene tick every
    few frames (the accumulation restarts at each upload) and arguments of
    every render_frame call; the window's checked frames, some of them the
    first after a restart, match the reference."""
    res = _run("cornell-interactive", seed=777 + every,
               extra=dict(tick_every=every, tick_fps=30,
                          render_args={"use_gbuffer": True},
                          check_within=6, check_frames=4), seconds=1.5)
    assert res["correct"], res["checks"]


def test_a_tick_that_uploads_nothing_is_not_correct(monkeypatch):
    """A tick whose upload leaves the accumulation running (no restart)
    is caught: the checked frames after it are off."""
    from webgpu_raytracer_tpu_torch.render.renderer import Renderer
    real = Renderer.reupload_scene
    monkeypatch.setattr(Renderer, "reupload_scene",
                        lambda self, reset=True: real(self, reset=False))
    res = _run("cornell-interactive", seed=4243,
               extra=dict(tick_every=2, tick_fps=30, check_within=6,
                          check_frames=6), seconds=1.5)
    assert not res["correct"], res["checks"]


def _render_fault(kind: str):
    from webgpu_raytracer_tpu_torch.render import renderer
    real = renderer.render_step

    def step(scene, camera, frame_count, jitter, accum, **kw):
        before = accum.clone()
        out, rays = real(scene, camera, frame_count, jitter, accum, **kw)
        if kind == "unchanged":
            out.copy_(before)
        elif kind == "half":
            half = out.shape[0] // 2
            out[half:] = before[half:]
        elif kind == "pixel":
            out[7, 1] += 0.25
        elif kind == "rays":
            rays = rays * 1.25
        return out, rays

    return renderer, "render_step", step


def _present_fault():
    from webgpu_raytracer_tpu_torch.render import renderer
    real = renderer.present_step

    def step(*a, **kw):
        ldr, hist = real(*a, **kw)
        ldr = ldr.clone()
        ldr[3, 5, 0] = (int(ldr[3, 5, 0]) + 128) % 256
        return ldr, hist

    return renderer, "present_step", step


def _png_fault():
    from webgpu_raytracer_tpu_torch.render import recorder
    real = recorder.png_rgb

    def png(img):
        img = img.copy()
        img[2, 2, 1] ^= 0x80
        return real(img)

    return recorder, "png_rgb", png


FAULTS = {
    "state_unchanged": lambda: _render_fault("unchanged"),
    "half_the_pixels_left_out": lambda: _render_fault("half"),
    "a_pixel_altered": lambda: _render_fault("pixel"),
    "the_ray_count_altered": lambda: _render_fault("rays"),
    "the_image_altered": _present_fault,
    "the_png_altered": _png_fault,
}


# Each cell with each fault it can have (only the record loop encodes PNGs).
CASES = [(w, f) for w in CELLS for f in sorted(FAULTS)
         if f != "the_png_altered" or "png_off_pct" in BENCH.limits(w)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    monkeypatch.setattr(*FAULTS[fault]())
    res = _run(workload, seed=4242)
    assert not res["correct"], res["checks"]


def test_reference_agrees_with_the_program_at_every_pixel():
    """One frame of cornell through the program's plain path, against the
    reference, bit for bit, with the ray count."""
    import numpy as np
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.ops.dense_trace import trace_pixels_dense
    from webgpu_raytracer_tpu_torch.render.worldtris import (
        build_world_tables)
    from webgpu_raytracer_tpu_torch.utils.halton import frame_jitter

    from portbench.reference import pathtrace as pt
    W, H, D, frame = 32, 24, 6, 987654
    w = NativeWorld("cornell")
    w.update_camera(W, H)
    cam = np.asarray(w.camera(), np.float32)
    col, rays = trace_pixels_dense(
        build_world_tables(w, "cpu"), torch.from_numpy(cam), frame,
        torch.from_numpy(frame_jitter(frame, W, H)), W, H, 1, D,
        with_stats=True)
    arr = check.scene_arrays("cornell", W, H, 0.0)
    ref, ref_rays = pt.radiance(pt.Scene(pt.world_tables(arr), "cpu"),
                                arr["camera"], torch.arange(W * H), frame,
                                W, H, D)
    assert torch.equal(ref, col)
    assert int(ref_rays.sum()) == int(rays)
