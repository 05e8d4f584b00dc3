"""The program's own spans on a traced run's timeline.

The program records spans of its host work (`span` in
`webgpu_raytracer_tpu_torch/utils/profiling.py`) on `time.time_ns()`
while a profiler records; a `Trace` holds times in seconds from the
profile's start. One constant maps the first onto the second. `align`
finds it by pairing the main thread's program spans named `render_frame`
and `present` with the harness's spans of the same names, which wrap
them: the last N of each name with the N in the trace (a profile taken
again leaves the earlier profile's spans behind). The offset is the
median of (harness start - program start) over the pairs. It returns
None, and no metric reads the spans, when the program records no spans
(a version without them), when it has fewer than the trace, when the
pairs' offsets spread (first to third quartile) more than `SPREAD_S`,
when the two names' median offsets differ by more (the pairs of one name
taken a call apart), or when a paired span maps outside the profiled
stretch by more.

The pairing counts on what the loops guarantee: the program records only
while the profiler does, and inside the profiled stretch it renders and
presents only inside the harness's spans of those names.
"""

from __future__ import annotations

import bisect
import statistics
import threading
from dataclasses import dataclass

from .profile import gaps

PAIRED = ("render_frame", "present")
SPREAD_S = 50e-6


def recorded() -> list:
    """The program's recorded spans; [] where the program has none."""
    try:
        from webgpu_raytracer_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def segments(spans) -> list:
    """(start, end, name) runs of the innermost span of properly nested
    (name, start, end) spans, in time order; time outside every span has
    no run."""
    out, stack, at = [], [], float("-inf")
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            if top[2] > at:
                out.append((at, top[2], top[0]))
                at = top[2]
        if stack and s > at:
            out.append((at, s, stack[-1][0]))
        at = max(at, s)
        stack.append((name, s, e))
    while stack:
        top = stack.pop()
        if top[2] > at:
            out.append((at, top[2], top[0]))
            at = top[2]
    return out


@dataclass
class Program:
    """The main thread's program spans, (name, start, end) in the trace's
    seconds, and how they were aligned: the offset (trace ns - program
    ns), each pair's offset less the first pair's, and their spread."""

    spans: list
    offset_ns: int
    offsets_ns: list
    spread_s: float

    def __post_init__(self):
        self.runs = segments(self.spans)
        self.starts = [r[0] for r in self.runs]

    def span_at(self, t: float) -> str:
        """The innermost program span open at t ('' if none)."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.runs[i][0] <= t < self.runs[i][1]:
            return self.runs[i][2]
        return ""

    def clipped(self, t0: float, t1: float) -> list:
        """The spans that overlap [t0, t1], clipped to it."""
        return [(n, max(s, t0), min(e, t1)) for n, s, e in self.spans
                if e > t0 and s < t1]

    def idle_by_span(self, trace) -> dict:
        """Device-idle seconds of the stretch (the gaps between the
        trace's operations) by the innermost program span the main thread
        was in ('' for time outside every program span)."""
        out = {"": 0.0}
        for gs, ge in gaps([(o.start, o.end) for o in trace.ops],
                           trace.t0, trace.t1):
            inside = 0.0
            i = max(bisect.bisect_right(self.starts, gs) - 1, 0)
            while i < len(self.runs) and self.runs[i][0] < ge:
                s, e, name = self.runs[i]
                cut = min(e, ge) - max(s, gs)
                if cut > 0:
                    out[name] = out.get(name, 0.0) + cut
                    inside += cut
                i += 1
            out[""] += (ge - gs) - inside
        return out


def align(trace, spans=None) -> Program | None:
    """The program's main-thread spans mapped onto `trace` (see the module
    docstring); `spans` defaults to what the program recorded."""
    main = threading.main_thread().native_id
    mine = sorted((s for s in (recorded() if spans is None else spans)
                   if s.thread == main), key=lambda s: s.start_ns)
    per_name, paired = [], []
    for name in PAIRED:
        theirs = [s for s in trace.spans if s[0] == name]
        ours = [s for s in mine if s.name == name]
        if not theirs or len(ours) < len(theirs):
            return None
        ours = ours[-len(theirs):]
        per_name.append([round(h[1] * 1e9) - p.start_ns
                         for h, p in zip(theirs, ours)])
        paired += ours
    # Relative to the first pair's, so the float arithmetic stays exact.
    first = per_name[0][0]
    per_name = [[o - first for o in offs] for offs in per_name]
    rel = [o for offs in per_name for o in offs]
    offset = first + round(statistics.median(rel))
    q = statistics.quantiles(rel, n=4) if len(rel) > 1 else [0, 0, 0]
    spread = (q[2] - q[0]) * 1e-9
    room = round(SPREAD_S * 1e9)
    medians = [statistics.median(offs) for offs in per_name]
    if spread > SPREAD_S or max(medians) - min(medians) > room:
        return None
    lo = round(trace.t0 * 1e9) - offset - room
    hi = round(trace.t1 * 1e9) - offset + room
    if any(p.start_ns < lo or p.end_ns > hi for p in paired):
        return None
    return Program([(s.name, (s.start_ns + offset) * 1e-9,
                     (s.end_ns + offset) * 1e-9) for s in mine],
                   offset, rel, spread)
