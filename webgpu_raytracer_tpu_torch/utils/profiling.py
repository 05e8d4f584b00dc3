"""Tracing / profiling helpers.

The port of the JAX package's `utils/profiling.py`: `FrameStats` (the
stats line: fps, ms and measured Mrays/s) and `device_trace` (a
`torch.profiler` trace of the CPU and the card, in place of
`jax.profiler`). `synchronize` waits for a device's queued work without
copying anything to the host.

Spans and counters of the program's own host work:

- `span(name, frame=None)` times a block on `time.time_ns()`, the clock
  that torch.profiler converts its timestamps to, so one constant maps a
  span onto a profile. A span records its name, id, the id of the
  enclosing open span on its thread (0 at the top), a frame id (given, or
  the enclosing span's), its thread's native id and its start and end ns.
  Spans record only while a torch profiler is recording or inside
  `tracing()`; otherwise `span` costs one flag check and returns one
  shared null context. They add no event to a profile. The last `LIMIT`
  spans are kept in memory and read with `spans()`.
- `count(name, value)` adds to a process-wide sum, always on, for rare
  events (a capture); `counters()` reads the sums.

`device_trace` is the one exporter: its `trace.json` holds the profile
and the spans recorded during its block, on the profile's timeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler


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


LIMIT = 200_000  # spans kept in memory; the oldest go first


class Span(NamedTuple):
    """One recorded span: times are `time.time_ns()` readings."""

    name: str
    id: int
    parent: int        # the enclosing span's id on this thread, 0 if none
    frame: Optional[int]
    thread: int        # the thread's native id, as a profile's tids
    start_ns: int
    end_ns: int


# Plain tuples: a Span is made when read, at ten times a tuple's cost.
_SPANS: collections.deque = collections.deque(maxlen=LIMIT)
_IDS = itertools.count(1)
_THREAD = threading.local()    # .state: this thread's _Thread
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_tracing = 0                   # depth of open tracing() blocks
_COUNTERS: dict = {}


class _Thread:
    """One thread's open spans and its native id, read once: reading it
    is a system call, microseconds on some hosts."""

    __slots__ = ("stack", "id")

    def __init__(self):
        self.stack, self.id = [], threading.get_native_id()


class _Open:
    """A span being timed; it records itself when it closes."""

    __slots__ = ("name", "frame", "id", "parent", "start", "thread")

    def __init__(self, name: str, frame: Optional[int]):
        self.name, self.frame = name, frame

    def __enter__(self):
        try:
            thread = _THREAD.state
        except AttributeError:
            thread = _THREAD.state = _Thread()
        stack = thread.stack
        if stack:
            up = stack[-1]
            self.parent = up.id
            if self.frame is None:
                self.frame = up.frame
        else:
            self.parent = 0
        self.id = next(_IDS)
        self.thread = thread
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        thread = self.thread
        thread.stack.pop()
        _SPANS.append((self.name, self.id, self.parent, self.frame,
                       thread.id, self.start, end))
        return False


def span(name: str, frame: Optional[int] = None):
    """A context manager that records the block as a span while a torch
    profiler records or inside `tracing()`, else the shared null context."""
    if not (_tracing or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, frame)


@contextlib.contextmanager
def tracing():
    """Records spans inside the block without a profiler (process-wide:
    every thread's spans record while any block is open)."""
    global _tracing
    with _LOCK:
        _tracing += 1
    try:
        yield
    finally:
        with _LOCK:
            _tracing -= 1


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most `LIMIT`)."""
    return [Span._make(s) for s in list(_SPANS)]


def count(name: str, value: float = 1) -> None:
    """Adds `value` to the process-wide counter `name`."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def counters() -> dict:
    """The counters' sums so far."""
    with _LOCK:
        return dict(_COUNTERS)


@contextlib.contextmanager
def device_trace(log_dir: str = "wrt_trace"):
    """A torch.profiler trace of the CPU and, where present, CUDA activity
    around a block, written as a Chrome trace (`trace.json`) into
    `log_dir`, with the program's spans recorded during the block merged
    in as `X` events of category "span" on the profile's timeline (one row
    a thread, with the thread's own operations); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = next(_IDS)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "frame": s.frame}}
        for s in spans() if s.id > first)
    with open(path, "w") as f:
        json.dump(trace, f)
