"""What the loops that drive the system under test share.

A loop is a module of its own, `loops/<loop>.py`, found by the name that a
traffic file gives under `"loop"`; its `run(cfg, traffic, seed, seconds,
trace, device, t_start, patterns)` builds the program from the
configuration (its preset, with the GLB of its `"model"` where it names
one: `scene_source`), warms up every step key its window will use (set-up), runs
the window for `seconds` with the traffic file's parameters and returns a
`Window`. `--seed` changes only the random streams and the choice of the
frames and pixels that the output check compares, never the scene, the
camera or the sizes, so every seed asks for the same work.

Snapshots for the output check (the accumulator before and after a frame,
the TAA history around a present, the image) are device copies taken
between frames, a few in a window.
"""

from __future__ import annotations

import gc
import random
import sys
import time

from . import spec
from .profile import Stretcher


def program():
    from webgpu_raytracer_tpu_torch import RenderConfig, Renderer, kernels
    return RenderConfig, Renderer, kernels


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def scene_source(cfg: dict) -> dict:
    """The keyword arguments that build the configuration's scene, beside
    its preset name, wherever a `Renderer` or a `NativeWorld` is made (the
    loops and the output check): `glb_data`, the bytes of
    `scenes/<model>.py`'s `glb()`, where the configuration names a
    `"model"`; none otherwise."""
    model = cfg.get("model")
    return {} if model is None else {"glb_data": spec.scene(model).glb()}


def pixels(rnd: random.Random, cfg: dict, device):
    """The pixels the check traces again: all, or `check_pixels` of them
    drawn from the seed, one in each of as many equal runs of the image
    in raster order (a stratified sample: the ray count scaled from them
    to the frame varies less than from pixels drawn anywhere)."""
    import torch
    n = cfg["width"] * cfg["height"]
    k = cfg.get("check_pixels")
    if not k or k >= n:
        idx = list(range(n))
    else:
        idx = [rnd.randrange(i * n // k, (i + 1) * n // k) for i in range(k)]
    return torch.tensor(idx, dtype=torch.int64, device=device)


def render_config(cfg: dict, **kw):
    RenderConfig = program()[0]
    return RenderConfig(width=cfg["width"], height=cfg["height"],
                        max_depth=cfg["max_depth"],
                        shader_spp=cfg["shader_spp"],
                        scene_name=cfg["scene"], **kw)


def stretcher(trace: bool, spans, traffic, seconds, patterns, outside):
    if not trace:
        return None
    return Stretcher(spans, program()[2].launches, patterns,
                     traffic["trace_after"] * seconds,
                     traffic["trace_seconds"], outside)


def more(t_open: float, seconds: float, stretch) -> bool:
    """Whether the window goes on: for `seconds`, and in a traced run
    until its profiled stretch is done."""
    return (time.perf_counter() - t_open < seconds
            or (stretch is not None and not stretch.done))


def memory_peak(device) -> int:
    import torch
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


def free() -> None:
    """Frees the program's device memory once the caller dropped it."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Phases:
    """The host clock's readings at the steps of set-up, in seconds from
    the process's start: printed on standard error, never a metric."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.marks: list = []

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t_start))

    def report(self) -> dict:
        out, at = {}, 0.0
        for name, t in self.marks:
            out[name] = t - at
            at = t
        print("setup phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in out.items()), file=sys.stderr)
        return out
