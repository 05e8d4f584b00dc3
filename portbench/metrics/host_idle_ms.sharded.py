"""Device-idle ms a sharded step during which the program's main thread
was inside one of its own spans: of the idle gaps between the stretch's
device operations on rank 0 (`lib.profile.gaps`), the time some program
span was open, over the steps in the stretch. The idle that is left is
the harness's own time between steps (the synchronise's return, the
jitter). A step has no present, so the program's spans are mapped onto
the stretch by its `sharded.step` spans, paired with the harness's spans
of that name that wrap them, as `lib/program.py` pairs `render_frame` and
`present`: the last N with the N in the trace, the median offset, and
nothing when the offsets spread (first to third quartile) more than
`SPREAD_S` or a paired span falls outside the stretch. None where the
program records no such spans or they do not align.

`SPREAD_S` is 200 us, not `lib/program.py`'s 50: under the profiler, on
an H100, the pairs of a 24-step stretch spread up to 31 us, and past 50
where the harness's span also held the jitter's two fills. A pairing off
by one step would spread by a step, 5 ms or more."""

import statistics
import threading

from portbench.lib.program import Program, recorded

PAIRED = "sharded.step"
SPREAD_S = 200e-6


def align(trace, spans=None):
    """The program's main-thread spans mapped onto `trace`, or None."""
    main = threading.main_thread().native_id
    mine = sorted((s for s in (recorded() if spans is None else spans)
                   if s.thread == main), key=lambda s: s.start_ns)
    theirs = [s for s in trace.spans if s[0] == PAIRED]
    ours = [s for s in mine if s.name == PAIRED]
    if not theirs or len(ours) < len(theirs):
        return None
    ours = ours[-len(theirs):]
    offs = [round(h[1] * 1e9) - p.start_ns for h, p in zip(theirs, ours)]
    # Relative to the first pair's, so the float arithmetic stays exact.
    rel = [o - offs[0] for o in offs]
    offset = offs[0] + round(statistics.median(rel))
    q = statistics.quantiles(rel, n=4) if len(rel) > 1 else [0, 0, 0]
    spread = (q[2] - q[0]) * 1e-9
    room = round(SPREAD_S * 1e9)
    lo = round(trace.t0 * 1e9) - offset - room
    hi = round(trace.t1 * 1e9) - offset + room
    if spread > SPREAD_S or any(p.start_ns < lo or p.end_ns > hi
                                for p in ours):
        return None
    return Program([(s.name, (s.start_ns + offset) * 1e-9,
                     (s.end_ns + offset) * 1e-9) for s in mine],
                   offset, rel, spread)


def read(trace, window):
    prog = align(trace)
    if prog is None or trace.frames == 0:
        return None
    split = prog.idle_by_span(trace)
    return 1e3 * (sum(split.values()) - split[""]) / trace.frames
