"""A viewer's closed loop of `Renderer.render_frame()` + `present()`; a
frame ends when `present()` has returned the 8-bit image to the host, and
the next starts then.

Traffic keys:

- `frames_before_window`: frames rendered in set-up; past 16, both present
  graphs (with and without the un-jitter resample) are captured;
- `first_frame`, `frame_span`: the window starts at the progressive frame
  count `first_frame` + (a number below `frame_span` drawn from the seed),
  as a resumed render's count does;
- `render_args` (optional): keyword arguments of every `render_frame`
  call, such as `{"use_gbuffer": true}` (a snapshot then says `gbuffer`:
  its frame's bounce 0 was seeded from the G-buffer);
- `tick_every`, `tick_fps` (optional): a scene tick every `tick_every`
  frames, as the upstream viewer's `update_interval`: at the start of such
  a frame the world is updated to (frame index) / `tick_fps` seconds on
  the bridge's thread while the frame renders, and at the start of the next
  the tables are uploaded and the accumulation restarts. Set-up ends with
  one tick. The seed moves the scene's clock, not the cadence;
- `check_frames`, `check_within`: the frames the output check traces again,
  drawn from the window's first `check_within`;
- `trace_after`, `trace_seconds`: the profiled stretch of a traced run, as
  a share of the window and in seconds.
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
    Renderer = drivers.program()[1]
    phases.mark("program import")
    rnd = random.Random(seed)
    r = Renderer(cfg["scene"], config=drivers.render_config(cfg),
                 device=device, narrow=cfg["narrow"],
                 **drivers.scene_source(cfg))
    phases.mark("renderer (scene compile, upload)")
    args = traffic.get("render_args", {})
    every = traffic.get("tick_every", 0)
    fps = traffic.get("tick_fps", 30)
    warm = traffic["frames_before_window"]
    first = traffic["first_frame"] + rnd.randrange(traffic["frame_span"])
    clock = dict(pending=0.0, scene=0.0)
    # The progressive frames since the accumulator's last restart, in the
    # order the jitter sequence saw them (the present's TAA input), as the
    # harness counts them: a checked frame is traced again as the frame
    # the harness expects, not as the one the program says it is at.
    seen = []

    def tick(i: int) -> None:
        clock["pending"] = (first + i) / fps
        r.bridge.update_async(clock["pending"])

    def upload() -> None:
        r.bridge.wait()
        r.reupload_scene(reset=True)
        clock["scene"] = clock["pending"]
        seen.clear()

    for i in range(warm):
        if every and i == warm - 2:
            tick(-1)
        if every and i == warm - 1:
            upload()
        r.render_frame(**args)
        r.present()
        seen.append(len(seen) + 1)
    phases.mark("warm-up (captures)")
    if not every:
        r.frame_count = first - 1
    count = first - 1 if not every else seen[-1]
    checks = set(rnd.sample(range(traffic["check_within"]),
                            traffic["check_frames"]))
    px = drivers.pixels(rnd, cfg, device)
    spans = Spans()
    stretch = drivers.stretcher(trace, spans, traffic, seconds, patterns,
                                "the harness's loop")
    rays, ends, snaps = [], [], []
    drivers.sync(device)

    t_open = time.perf_counter()
    while drivers.more(t_open, seconds, stretch):
        k = len(ends)
        with spans("frame"):
            if every and k % every == 0:
                with spans("tick"):
                    tick(k)
            if every and k % every == 1 % every:
                with spans("reupload_scene"):
                    upload()
            if k in checks:
                before = r.accum.clone(), r.history.clone()
            with spans("render_frame"):
                r.render_frame(**args)
            with spans("present"):
                ldr = r.present()
        ends.append(time.perf_counter())
        rays.append(r.last_rays)
        count = 1 if not seen else count + 1
        seen.append(count)
        if k in checks:
            after = r.accum.clone()
            snaps.append(dict(
                frame=count, pixels=px, before=before[0],
                after=after, rays=r.last_rays.clone(), time=clock["scene"],
                gbuffer=bool(args.get("use_gbuffer")),
                present=dict(
                    frame=count, accum=after, hist_before=before[1],
                    hist_after=r.history.clone(), ldr=ldr,
                    frames=list(seen))))
        if stretch:
            stretch.boundary(ends[-1], t_open, rays, k + 1)
    if stretch:
        stretch.close()
    r.bridge.wait()
    drivers.sync(device)
    peak = drivers.memory_peak(device)
    total = float(torch.stack(rays).sum()) if rays else 0.0
    del r
    drivers.free()
    if len(snaps) != len(checks):
        raise RuntimeError(f"the window completed {len(ends)} frames, fewer "
                           f"than the {traffic['check_within']} its checks "
                           f"are drawn from")
    return Window(setup_s=t_open - phases.t_start, t_open=t_open, ends=ends,
                  rays=total, pixels=cfg["width"] * cfg["height"],
                  tris=0, light_rows=0, snapshots=snaps,
                  trace=stretch.trace if stretch else None,
                  memory_peak_bytes=peak, phases=phases.report())
