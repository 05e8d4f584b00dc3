#!/usr/bin/env python3
"""Where the animated tick's time goes on the card (bench.py's config 4).

Run from a checkout's root on a machine with one NVIDIA GPU:

    python3 tools/torch_anim_tick.py [--frames 24] [--passes 3]

The skinned strip GLB (`tests/glb_fixture.skinned_strip_glb`, 2
triangles) at 512^2 d8, ticked at 30 Hz scene time, in turns (each pass
runs every mode once, the order rotating from pass to pass):

- `overlap`: bench.py's anim_pass order through `Renderer.bridge`: wait for
  the tick, `reupload_scene`, kick the next tick (`update_async`, a new
  thread), render;
- `overlap_fast_switch`: the same with `sys.setswitchinterval(1e-5)`, so the
  bridge's thread gets the interpreter lock without waiting out the
  default 5 ms switch interval;
- `sequential`: `update_scene(t)` then render, on the calling thread.

Each pass ends in one synchronise. Per mode it prints fps and the host ms of
each step of a frame (mean over frames; a step's host time is the time
until the call returns, not the device's). Then one JSON line. Frames are
held bit-equal across the modes (frame k of every mode is the same tick).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from webgpu_raytracer_tpu_torch import Renderer, RenderConfig  # noqa: E402
from webgpu_raytracer_tpu_torch.utils.profiling import synchronize  # noqa

from tests.glb_fixture import skinned_strip_glb  # noqa: E402


def renderer(dev):
    r = Renderer("viewer", glb_data=skinned_strip_glb(),
                 config=RenderConfig(width=512, height=512, max_depth=8,
                                     shader_spp=1), device=dev)
    for t in (0.0, 1 / 30, 2 / 30):  # warm-up
        r.update_scene(t)
        r.render_frame()
    synchronize(dev)
    return r


def overlap(r, times, steps, frames):
    r.bridge.update_async(times[0])
    for k in range(len(times)):
        t0 = time.perf_counter()
        r.bridge.wait()
        t1 = time.perf_counter()
        r.reupload_scene()
        t2 = time.perf_counter()
        if k + 1 < len(times):
            r.bridge.update_async(times[k + 1])
        t3 = time.perf_counter()
        frames.append(r.render_frame().clone())
        t4 = time.perf_counter()
        steps["wait"].append(t1 - t0)
        steps["upload"].append(t2 - t1)
        steps["kick"].append(t3 - t2)
        steps["render"].append(t4 - t3)


def sequential(r, times, steps, frames):
    for t in times:
        t0 = time.perf_counter()
        r.world.update(t)
        t1 = time.perf_counter()
        r.reupload_scene()
        t2 = time.perf_counter()
        frames.append(r.render_frame().clone())
        t3 = time.perf_counter()
        steps["update"].append(t1 - t0)
        steps["upload"].append(t2 - t1)
        steps["render"].append(t3 - t2)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_anim_tick: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    r = renderer(dev)
    modes = ["overlap", "overlap_fast_switch", "sequential"]
    fps = {m: [] for m in modes}
    steps_all = {m: {} for m in modes}
    ref = None
    default_switch = sys.getswitchinterval()
    for p in range(args.passes):
        order = modes[p % 3:] + modes[:p % 3]
        for mode in order:
            times = [(3 + k) / 30.0 for k in range(args.frames)]
            steps = {k: [] for k in ("wait", "upload", "kick", "render",
                                     "update")}
            frames = []
            if mode == "overlap_fast_switch":
                sys.setswitchinterval(1e-5)
            try:
                t0 = time.perf_counter()
                (sequential if mode == "sequential" else overlap)(
                    r, times, steps, frames)
                synchronize(dev)
                seconds = time.perf_counter() - t0
            finally:
                sys.setswitchinterval(default_switch)
            if ref is None:
                ref = frames
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(frames, ref)), f"{mode} differs"
            fps[mode].append(args.frames / seconds)
            for k, v in steps.items():
                if v:
                    steps_all[mode].setdefault(k, []).extend(v)
            print(f"pass {p} {mode}: {args.frames / seconds:.2f} fps; host ms "
                  + ", ".join(f"{k} {1e3 * np.mean(v):.3f}"
                              for k, v in steps.items() if v))
    out = {"card": smi, "frames": args.frames, "fps": fps,
           "host_ms": {m: {k: 1e3 * float(np.mean(v)) for k, v in s.items()}
                       for m, s in steps_all.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
