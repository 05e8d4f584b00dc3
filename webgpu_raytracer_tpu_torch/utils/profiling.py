"""Tracing / profiling helpers.

The port of the JAX package's `utils/profiling.py`: `FrameStats` (the
stats line: fps, ms and measured Mrays/s), `PassTimer` (named wall-clock
sections that wait for the device) and `device_trace` (a `torch.profiler`
trace of the CPU and the card, in place of `jax.profiler`). `synchronize`
waits for a device's queued work without copying anything to the host.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch


def synchronize(device) -> None:
    """Wait for the work queued on `device`'s current stream, where the
    port queues all of its work (a no-op on the CPU, where PyTorch runs
    synchronously). Not the whole device: another thread may be capturing
    a frame step on its own stream (the farm's workers), and CUDA refuses
    a device-wide synchronise during a capture."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclass
class FrameStats:
    """Running render statistics (the stats-overlay analogue).

    Ray counts are EXACT: record() takes the per-frame traced-ray count the
    render step returns (Renderer.last_rays — primary + NEE shadow +
    extension lanes actually swept), so rays_per_sec is measured, not
    modeled."""

    width: int
    height: int
    spp: int
    max_depth: int
    frame_times_ms: List[float] = field(default_factory=list)
    frame_rays: List[float] = field(default_factory=list)
    window: int = 60

    def record(self, dt_s: float, rays: float = 0.0):
        self.frame_times_ms.append(dt_s * 1000.0)
        self.frame_rays.append(float(rays))
        if len(self.frame_times_ms) > self.window:
            self.frame_times_ms.pop(0)
            self.frame_rays.pop(0)

    @property
    def ms(self) -> float:
        return float(np.mean(self.frame_times_ms)) if self.frame_times_ms else 0.0

    @property
    def fps(self) -> float:
        return 1000.0 / self.ms if self.ms > 0 else 0.0

    def rays_per_sec(self) -> float:
        """Measured rays/sec over the window (exact counts / wall time)."""
        wall_s = float(np.sum(self.frame_times_ms)) / 1000.0
        if wall_s <= 0:
            return 0.0
        return float(np.sum(self.frame_rays)) / wall_s

    def line(self) -> str:
        return (f"fps={self.fps:.1f} ms={self.ms:.1f} "
                f"{self.rays_per_sec() / 1e6:.1f} Mrays/s")


class PassTimer:
    """Named wall-clock sections with device sync, for coarse pass timing."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        """Time the block; with `sync_value` (a tensor), wait for its
        device before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            synchronize(sync_value.device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name}: {total * 1000 / max(n, 1):.2f} ms avg "
                         f"({n} calls, {total:.3f}s total)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str = "wrt_trace"):
    """A torch.profiler trace of the CPU and, where present, CUDA activity
    around a block, written as a Chrome trace (`trace.json`) into
    `log_dir`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
