"""`VideoRecorder.record_chunks` at the recording defaults: `spp` samples
a recorded frame in the recorder's own batches, each recorded frame a
scene tick and upload, its samples, one `present` and a PNG encode.

Traffic keys:

- `spp`, `batch`, `fps`: the recorder's settings (`RenderConfig`);
- `start_frames`: the chunk starts at a frame drawn from the seed below
  this, as a farm job's chunk does;
- `check_within`, `check_samples`: the recorded frame the output check
  traces again, drawn from the window's first `check_within`, and how
  many of its samples (sample 1, which overwrites the accumulator, always);
- `trace_after`, `trace_seconds`: the profiled stretch of a traced run.

Set-up records one frame, TAA warm-up included. The window is one chunk
that ends at the first recorded frame that completes past `seconds`.
Spans come from wrappers of the instance's `render_frame`, `present` and
`reupload_scene`: nothing is added inside the program.
"""

from __future__ import annotations

import random
import time

import torch

from portbench.lib import drivers
from portbench.lib.profile import Spans
from portbench.lib.window import Window


def run(cfg, traffic, seed, seconds, trace, device, phases,
        patterns) -> Window:
    from webgpu_raytracer_tpu_torch.render.recorder import (AbortFlag,
                                                            VideoRecorder)
    Renderer = drivers.program()[1]
    phases.mark("program import")
    rnd = random.Random(seed)
    rc = drivers.render_config(cfg, spp=traffic["spp"],
                               batch=traffic["batch"], fps=traffic["fps"])
    r = Renderer(cfg["scene"], config=rc, device=device,
                 narrow=cfg["narrow"], **drivers.scene_source(cfg))
    phases.mark("renderer (scene compile, upload)")
    rec = VideoRecorder(r)
    start = rnd.randrange(traffic["start_frames"])
    rec.record_chunks(rc, start, 1)
    drivers.sync(device)
    phases.mark("warm-up (captures)")

    check_q = rnd.randrange(traffic["check_within"])
    # Sample 1 overwrites the accumulator (the start of every recorded
    # frame): always checked, beside samples drawn from the seed.
    check_s = {1} | set(rnd.sample(range(2, traffic["spp"] + 1),
                                   traffic["check_samples"] - 1))
    px = drivers.pixels(rnd, cfg, device)
    spans = Spans()
    stretch = drivers.stretcher(trace, spans, traffic, seconds, patterns,
                                "the recorder (PNG, tick, batch control)")
    rays, ends, snaps = [], [], []
    at = dict(uploads=0, sample=0)
    present_snap = {}

    # A checked frame is traced again as the sample the harness counts
    # since the recorded frame's upload, not as the frame the program says
    # it is at.

    def mine() -> bool:
        # The window's chunk uploads once to bootstrap, then once a frame.
        return at["uploads"] - 2 == check_q

    orig_upload, orig_render, orig_present = (r.reupload_scene,
                                              r.render_frame, r.present)

    def reupload_scene(*a, **kw):
        with spans("reupload_scene"):
            out = orig_upload(*a, **kw)
        at["uploads"] += 1
        at["sample"] = 0
        return out

    def render_frame(*a, **kw):
        at["sample"] += 1
        snap = mine() and at["sample"] in check_s
        if snap:
            before = r.accum.clone()
        with spans("render_frame"):
            out = orig_render(*a, **kw)
        rays.append(r.last_rays)
        if snap:
            snaps.append(dict(frame=at["sample"], pixels=px,
                              before=before, after=r.accum.clone(),
                              rays=r.last_rays.clone(),
                              time=(start + check_q) / traffic["fps"]))
        return out

    def present(*a, **kw):
        snap = mine()
        if snap:
            hist = r.history.clone()
        with spans("present"):
            ldr = orig_present(*a, **kw)
        if snap:
            present_snap.update(
                frame=at["sample"], accum=r.accum.clone(), hist_before=hist,
                hist_after=r.history.clone(), ldr=ldr,
                frames=list(range(1, at["sample"] + 1)))
        return ldr

    r.reupload_scene, r.render_frame, r.present = (reupload_scene,
                                                    render_frame, present)
    abort = AbortFlag()

    def on_progress(done, total):
        ends.append(time.perf_counter())
        if stretch:
            stretch.boundary(ends[-1], t_open, rays, done)
        if not drivers.more(t_open, seconds, stretch):
            abort.abort()

    t_open = time.perf_counter()
    frames = rec.record_chunks(rc, start, 10 ** 6, on_progress, abort)
    r.bridge.wait()
    if stretch:
        stretch.close()
    drivers.sync(device)
    peak = drivers.memory_peak(device)
    total = float(torch.stack(rays).sum()) if rays else 0.0
    r.reupload_scene, r.render_frame, r.present = (orig_upload, orig_render,
                                                    orig_present)
    del r, rec
    drivers.free()
    if len(snaps) != len(check_s) or not present_snap \
            or len(frames) <= check_q:
        raise RuntimeError(f"the window recorded {len(frames)} frames, "
                           f"fewer than the {traffic['check_within']} its "
                           f"checks are drawn from")
    present_snap["png"] = frames[check_q].data
    snaps[-1]["present"] = present_snap
    return Window(setup_s=t_open - phases.t_start, t_open=t_open, ends=ends,
                  rays=total, pixels=cfg["width"] * cfg["height"],
                  tris=0, light_rows=0, snapshots=snaps,
                  trace=stretch.trace if stretch else None,
                  memory_peak_bytes=peak, phases=phases.report())
