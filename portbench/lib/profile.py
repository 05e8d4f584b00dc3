"""The traced run: spans around the calls into the program's layers, one
profiled stretch of the window, and what the per-layer metrics read from it.

`torch.profiler` records the device's operations (kernels, copies, fills)
with their device times, and the host's runtime calls that launched them.
An operation is attributed to the innermost harness span that was open when
the host call that launched it ran (a CUDA graph's kernels all share the
correlation of its one launch), never by overlapping time. The records stay
in memory. A profile whose kernel counts differ from the program's own
launch counters over the same stretch has lost records: it is taken again,
up to `TRIES` times, and then the run fails rather than report a short
count.
"""

from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass, field

SPAN = "portbench."
TRIES = 3


class Spans:
    """Harness spans; they cost nothing while no stretch is profiled."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(SPAN + name)


def union(intervals) -> list:
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, t0: float, t1: float) -> list:
    return [(max(s, t0), min(e, t1)) for s, e in intervals
            if e > t0 and s < t1]


def busy(intervals, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some interval runs."""
    return sum(e - s for s, e in clip(union(intervals), t0, t1))


def gaps(intervals, t0: float, t1: float) -> list:
    """The idle (start, end) stretches of [t0, t1] between the intervals."""
    out, at = [], t0
    for s, e in clip(union(intervals), t0, t1):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return out


@dataclass
class Op:
    """One device operation: device start and end, the host launch time
    (None when no launch was recorded) and its span ('' outside any)."""

    name: str
    start: float
    end: float
    launch: float | None
    span: str


@dataclass
class Trace:
    """One profiled stretch, times in seconds on the host's timeline."""

    ops: list
    spans: list             # (name, start, end), sorted by start
    t0: float
    t1: float
    frames: int             # render_frame calls inside the stretch
    presents: int           # present calls inside the stretch
    rays: float             # the exact rays of those frames
    launches: dict          # counter -> launches inside the stretch
    outside: str = "outside spans"  # what the host does outside the spans
    log: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return busy([(o.start, o.end) for o in self.ops], self.t0, self.t1)

    def device_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(o.end - o.start for o in self.ops if rx.search(o.name))

    def span_at(self, t: float) -> str:
        """The innermost span open at host time t ('' if none)."""
        best, start = "", -1.0
        for name, s, e in self.spans:
            if s <= t <= e and s >= start and name != "stretch":
                best, start = name, s
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, each named by the span the host was in at its
        middle."""
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps([(o.start, o.end) for o in self.ops],
                           self.t0, self.t1), key=lambda g: g[0] - g[1])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.span_at((s + e) / 2) or self.outside,
                               e - s] for s, e in idle[:top]]}


def parse(events, patterns: dict) -> tuple:
    """(ops, spans, stretch (t0, t1), kernels seen by counter) of a
    profile's events."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted(((e.name[len(SPAN):], e.time_range.start * 1e-6,
                     e.time_range.end * 1e-6) for e in cpu
                    if e.name.startswith(SPAN)), key=lambda s: s[1])
    launch = {e.id: e.time_range.start * 1e-6 for e in cpu
              if e.name.startswith("cu")}
    stretch = [s for s in spans if s[0] == "stretch"]
    if len(stretch) != 1:
        raise RuntimeError(f"profile: {len(stretch)} stretch spans")
    t0, t1 = stretch[0][1:]
    ops = []
    for e in events:
        # The device timeline also carries the spans' own ranges.
        if e.device_type != DeviceType.CUDA or e.name.startswith(SPAN):
            continue
        at = launch.get(e.id)
        ops.append(Op(e.name, e.time_range.start * 1e-6,
                      e.time_range.end * 1e-6, at, ""))
    inner = [s for s in spans if s[0] != "stretch"]
    at, open_ = 0, []
    for o in sorted((o for o in ops if o.launch is not None),
                    key=lambda o: o.launch):
        while at < len(inner) and inner[at][1] <= o.launch:
            open_.append(inner[at])
            at += 1
        open_ = [s for s in open_ if s[2] >= o.launch]
        if open_:
            o.span = max(open_, key=lambda s: s[1])[0]
    counted = {k: sum(1 for o in ops if re.search(p, o.name))
               for k, p in patterns.items()}
    return ops, spans, (t0, t1), counted


class Stretcher:
    """Profiles one steady stretch of a window, at frame boundaries: it
    starts at the first boundary `after_s` into the window and stops at the
    first boundary `length_s` later (two frames at least), then checks the
    profile against the program's launch counters. `launches` is the
    program's counter dict; `rays` the window's list of per-frame ray
    counts (device scalars), `presents` the window's present count so
    far. `outside` names what the host does outside the harness's spans.
    A traced window runs on until its stretch is done (`done`)."""

    def __init__(self, spans: Spans, launches: dict, patterns: dict,
                 after_s: float, length_s: float, outside: str):
        self.outside = outside
        self.spans = spans
        self.launches = launches
        self.patterns = patterns
        self.after_s = after_s
        self.length_s = length_s
        self.tries = 0
        self.prof = None
        self.trace: Trace | None = None
        self.log: list = []

    @property
    def done(self) -> bool:
        return self.trace is not None

    def boundary(self, now: float, t_open: float, rays: list,
                 presents: int) -> None:
        if self.trace is not None:
            return
        if self.prof is None:
            if now - t_open >= self.after_s:
                self._start(now, rays, presents)
            return
        if now - self.t_start >= self.length_s and \
                len(rays) - self.rays0 >= 2:
            self._stop(rays, presents)

    def _start(self, now, rays, presents):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.on = True
        self.stretch = self.spans("stretch")
        self.stretch.__enter__()
        # After the profiler's own start, which can take a second.
        self.t_start = time.perf_counter()
        self.rays0, self.presents0 = len(rays), presents
        self.before = dict(self.launches)

    def _stop(self, rays, presents):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.stretch.__exit__(None, None, None)
        self.spans.on = False
        self.prof.__exit__(None, None, None)
        prof, self.prof = self.prof, None
        launches = {k: v - self.before.get(k, 0)
                    for k, v in self.launches.items()}
        t = time.perf_counter()
        ops, spans, (t0, t1), counted = parse(prof.events(), self.patterns)
        self.log.append(f"profile {self.tries + 1}: {len(ops)} device ops, "
                        f"parsed in {time.perf_counter() - t:.1f} s")
        self.tries += 1
        short = {k: (counted[k], launches.get(k, 0)) for k in counted
                 if counted[k] != launches.get(k, 0)}
        if short:
            self.log.append(f"profile {self.tries}: kernels seen / launched "
                            f"differ: {short}")
            if self.tries >= TRIES:
                raise RuntimeError(f"the profiler lost records in {TRIES} "
                                   f"profiles: {short}")
            return
        frame_rays = rays[self.rays0:]
        self.trace = Trace(
            ops=[o for o in ops if o.end > t0 and o.start < t1],
            spans=spans, t0=t0, t1=t1, frames=len(frame_rays),
            presents=presents - self.presents0,
            rays=float(sum(float(r) for r in frame_rays)),
            launches={k: v for k, v in launches.items() if v},
            outside=self.outside, log=self.log)

    def close(self) -> None:
        """Ends a stretch that the window's end cut short."""
        if self.prof is not None:
            self.stretch.__exit__(None, None, None)
            self.spans.on = False
            self.prof.__exit__(None, None, None)
            self.prof = None
