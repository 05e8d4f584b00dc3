"""The program's spans on a synthetic trace (`lib/program.py`) and the
arithmetic of the readers of `program_span` and `program_counter`
metrics."""

from __future__ import annotations

import statistics
import threading

import pytest

from portbench.lib import program, spec
from portbench.lib.profile import Op, Trace
from webgpu_raytracer_tpu_torch.utils import profiling
from webgpu_raytracer_tpu_torch.utils.profiling import Span

BENCH = spec.Spec()
MAIN = threading.main_thread().native_id
# trace ns - program ns: the program's clock is Unix time, the trace's
# starts at its profile.
OFFSET = -1_790_000_000_000_000_000 + 123_456


def _span(name, start_s, end_s, id_=0, parent=0, thread=MAIN, delay=0):
    """A program span that sits at [start_s, end_s] of the trace, opened
    `delay` ns after that."""
    return Span(name, id_, parent, None, thread,
                round(start_s * 1e9) - OFFSET + delay,
                round(end_s * 1e9) - OFFSET)


def _trace(ops=(), spans=(), t0=0.0, t1=0.005, presents=1):
    return Trace(ops=[Op(n, s, e, None, "") for n, s, e in ops],
                 spans=[("stretch", t0, t1)] + list(spans), t0=t0, t1=t1,
                 frames=presents, presents=presents, rays=0.0, launches={})


def _frames(n, delays, period=0.003):
    """n frames: the harness's spans and the program's, each program span
    opened `delays[k]` ns after the harness's."""
    theirs, ours = [], []
    for k in range(n):
        f = 0.001 + k * period
        theirs += [("render_frame", f, f + 0.001),
                   ("present", f + 0.0012, f + 0.002)]
        ours += [_span("render_frame", f, f + 0.001, delay=delays[k]),
                 _span("present", f + 0.0012, f + 0.002, delay=delays[k])]
    return theirs, ours


def test_align_recovers_the_offset():
    theirs, ours = _frames(8, [3000, 5000, 4000, 5000, 6000, 5000, 5000,
                               7000])
    # An earlier profile's spans and another thread's are left out.
    stale = [_span("render_frame", -1.0, -0.999),
             _span("present", -0.998, -0.997)]
    other = [_span("render_frame", 0.001, 0.002, thread=MAIN + 1)]
    t = _trace(spans=theirs, t1=0.03)
    prog = program.align(t, stale + other + ours)
    assert prog is not None
    assert prog.offset_ns == OFFSET - 5000
    assert len(prog.offsets_ns) == 16
    q = statistics.quantiles(prog.offsets_ns, n=4)
    assert prog.spread_s == pytest.approx((q[2] - q[0]) * 1e-9)
    assert prog.spread_s < 2e-6
    # Mapped by the median: opened 3 us late where the median is 5.
    stale_, first = [s for s in prog.spans if s[0] == "render_frame"][:2]
    assert first[1] == pytest.approx(0.001 - 2e-6, abs=1e-9)
    assert stale_[1] == pytest.approx(-1.0 - 5e-6, abs=1e-9)


@pytest.mark.parametrize("case", ["spread", "fewer", "none", "names",
                                  "outside"])
def test_align_refuses(case):
    delays = [0, 120_000] * 4 if case == "spread" else [2000] * 8
    theirs, ours = _frames(8, delays)
    t = _trace(spans=theirs, t1=0.03)
    if case == "fewer":
        ours = ours[2:]
    if case == "none":
        ours = []
    if case == "names":
        # The presents paired one call apart, the frames right.
        ours = [s._replace(start_ns=s.start_ns + 3_000_000,
                           end_ns=s.end_ns + 3_000_000)
                if s.name == "present" else s for s in ours]
    if case == "outside":
        t = _trace(spans=theirs, t1=0.02)
    assert program.align(t, ours) is None


def _one_frame():
    """One frame in a 5 ms stretch: the program's spans start with the
    harness's (render_frame 1-2 ms, its inputs 1-1.2; present 3-4, its
    copy 3.5-4) and the device runs 1.1-1.15, 1.5-3.2 and 3.6-3.9 ms."""
    ms = 1e-3
    ours = [_span("render_frame", 1 * ms, 2 * ms, 1),
            _span("render_frame.inputs", 1 * ms, 1.2 * ms, 2, 1),
            _span("present", 3 * ms, 4 * ms, 3),
            _span("present.copy", 3.5 * ms, 4 * ms, 4, 3)]
    ops = [("k", 1.1 * ms, 1.15 * ms), ("k", 1.5 * ms, 3.2 * ms),
           ("k", 3.6 * ms, 3.9 * ms)]
    theirs = [("render_frame", 1 * ms, 2 * ms), ("present", 3 * ms, 4 * ms)]
    return _trace(ops, theirs), ours


def test_idle_goes_to_the_innermost_span(monkeypatch):
    t, ours = _one_frame()
    prog = program.align(t, ours)
    split = {k: 1e3 * v for k, v in prog.idle_by_span(t).items()}
    assert split == pytest.approx({
        "": 2.0, "render_frame.inputs": 0.15, "render_frame": 0.3,
        "present": 0.3, "present.copy": 0.2})
    assert prog.span_at(1.1e-3) == "render_frame.inputs"
    assert prog.span_at(1.5e-3) == "render_frame"
    assert prog.span_at(0.5e-3) == "" and prog.span_at(4.5e-3) == ""
    monkeypatch.setattr(program, "recorded", lambda: ours)
    for name in ("host_idle_ms.interactive", "host_idle_ms.record"):
        got = BENCH.reader("per_layer", name).read(t, None)
        assert got == pytest.approx(0.95)
    t.presents = 2
    assert BENCH.reader("per_layer", "host_idle_ms.record").read(
        t, None) == pytest.approx(0.475)


def test_segments_of_nested_spans():
    runs = program.segments([("a", 0, 10), ("b", 2, 4), ("c", 3, 4),
                             ("d", 6, 7), ("e", 12, 13)])
    assert runs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                    (6, 7, "d"), (7, 10, "a"), (12, 13, "e")]


def test_png_ms_per_recorded_frame(monkeypatch):
    t, ours = _one_frame()
    ms = 1e-3
    t.presents = 2
    ours += [_span("record.png", 2.2 * ms, 2.8 * ms, 5),
             _span("record.png", 4.5 * ms, 5.5 * ms, 6)]   # cut at 5 ms
    monkeypatch.setattr(program, "recorded", lambda: ours)
    got = BENCH.reader("per_layer", "record.png_ms").read(t, None)
    assert got == pytest.approx((0.6 + 0.5) / 2)


def test_without_program_spans_the_readers_read_nothing(monkeypatch):
    t, _ = _one_frame()
    monkeypatch.setattr(program, "recorded", lambda: [])
    for name in ("host_idle_ms.interactive", "host_idle_ms.record",
                 "record.png_ms"):
        assert BENCH.reader("per_layer", name).read(t, None) is None


def test_capture_ms_reads_the_counter(monkeypatch):
    reader = BENCH.reader("per_layer", "capture_ms")
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"captures": 3, "capture_ms": 812.5})
    assert reader.read(None, None) == 812.5
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert reader.read(None, None) is None
