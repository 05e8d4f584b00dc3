"""The port's spans and counters (`utils/profiling.py`), on the CPU.

- `span` off (no profiler, no `tracing()`): the one shared null context,
  nothing recorded.
- Under `tracing()`: nesting gives the parent's id, a frame id given or
  inherited, the thread's native id (another thread starts its own
  tree), and the buffer keeps only the newest spans.
- Inside a `torch.profiler.profile`, spans record and add no event: the
  profile's events are those of the same block without spans.
- `device_trace`'s `trace.json` holds a program span whose [ts, ts + dur]
  encloses the `aten::sum` launched inside it: one clock.
- `count` / `counters`, and the capture counters of `CapturedSteps`.
- A CPU `Renderer` frame gives the `render_frame` / `present` tree (and,
  through `CapturedSteps` with the graph stand-in, the steps' spans); a
  reupload its `upload.*` spans; `record_chunks` one `record.frame` a
  recorded frame, the wait for the last frame's encode (`record.png`)
  inside the next frame's and after the loop, the encode itself
  (`record.png.encode`) on its own thread, and `on_progress` outside.
"""

import collections
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from webgpu_raytracer_tpu_torch import Renderer, RenderConfig
from webgpu_raytracer_tpu_torch.render import renderer as prr
from webgpu_raytracer_tpu_torch.render.recorder import VideoRecorder
from webgpu_raytracer_tpu_torch.utils import profiling
from webgpu_raytracer_tpu_torch.utils.profiling import (count, counters,
                                                        device_trace, span,
                                                        spans, tracing)

from tests.torch_common import record_eagerly


def _since(mark):
    """The spans recorded after the span `mark` opened, by id."""
    return [s for s in spans() if s.id > mark.id]


def _mark():
    with tracing():
        with span("mark") as m:
            pass
    return m


def test_span_off_is_the_shared_null_context():
    n = len(spans())
    a, b = span("a"), span("b", frame=3)
    assert a is b is profiling._NULL
    with span("c") as c:
        assert c is None
    assert len(spans()) == n


def test_span_tree_frame_and_thread():
    seen = {}

    def worker():
        with span("worker") as w:
            seen["id"] = w.id

    with tracing():
        with span("outer", frame=7) as outer:
            with span("inner") as inner:
                with span("leaf", frame=9):
                    pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    by = {s.name: s for s in _since(outer)}
    by["outer"] = next(s for s in spans() if s.id == outer.id)
    assert by["outer"].parent == 0 and by["outer"].frame == 7
    assert by["inner"].parent == outer.id and by["inner"].frame == 7
    assert by["leaf"].parent == inner.id and by["leaf"].frame == 9
    assert by["worker"].parent == 0 and by["worker"].frame is None
    assert by["worker"].id == seen["id"]
    main = threading.get_native_id()
    assert {by[k].thread for k in ("outer", "inner", "leaf")} == {main}
    assert by["worker"].thread != main
    for s in by.values():
        assert s.start_ns <= s.end_ns
    assert by["outer"].start_ns <= by["inner"].start_ns
    assert by["inner"].end_ns <= by["outer"].end_ns


def test_buffer_keeps_the_newest(monkeypatch):
    assert profiling._SPANS.maxlen == profiling.LIMIT
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(maxlen=5))
    with tracing():
        for k in range(12):
            with span(f"s{k}"):
                pass
    assert [s.name for s in spans()] == [f"s{k}" for k in range(7, 12)]


def test_spans_record_in_a_profile_and_add_no_event():
    def block(with_spans):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with (span("outer") if with_spans else profiling._NULL):
                x = torch.ones(16)
                with (span("inner") if with_spans else profiling._NULL):
                    x.sum()
        return [e.name for e in prof.events()]

    m = _mark()
    plain = block(False)
    traced = block(True)
    assert [s.name for s in _since(m)] == ["inner", "outer"]
    assert traced == plain
    assert not {"outer", "inner"} & set(traced)


def test_device_trace_puts_spans_on_the_profile_clock(tmp_path):
    with device_trace(str(tmp_path)):
        with span("sum", frame=4):
            torch.ones(1 << 12).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in mine] == ["sum"]
    assert mine[0]["args"]["frame"] == 4
    sums = [e for e in events if e.get("name") == "aten::sum"]
    assert sums
    outer = min(sums, key=lambda e: e["ts"])
    assert mine[0]["tid"] == outer["tid"]
    assert mine[0]["ts"] <= outer["ts"]
    assert outer["ts"] + outer["dur"] <= mine[0]["ts"] + mine[0]["dur"]


def test_counters_add_up():
    before = counters()
    count("test.events")
    count("test.events", 2)
    count("test.ms", 1.5)
    after = counters()
    assert after["test.events"] - before.get("test.events", 0) == 3
    assert after["test.ms"] - before.get("test.ms", 0) == pytest.approx(1.5)


def _tree(mark):
    """{span name: [parent names]} of the spans after `mark`."""
    mine = _since(mark)
    names = {s.id: s.name for s in mine}
    out = {}
    for s in mine:
        out.setdefault(s.name, []).append(names.get(s.parent, ""))
    return out, mine


def test_renderer_frame_span_tree():
    r = Renderer("cornell", config=RenderConfig(width=8, height=6,
                                                max_depth=1), device="cpu")
    m = _mark()
    with tracing():
        r.render_frame()
        r.present()
        r.reupload_scene()
    tree, mine = _tree(m)
    assert tree == {
        "render_frame.inputs": ["render_frame"],
        "steps.run": ["render_frame", "present"],
        "render_frame": [""], "present.inputs": ["present"],
        "present.copy": ["present"], "present": [""],
        "upload.tables": ["reupload_scene"],
        "upload.camera": ["reupload_scene"], "reupload_scene": [""]}
    frames = {s.name: s.frame for s in mine}
    assert frames["render_frame"] == frames["present"] == 1
    assert frames["steps.run"] == 1 and frames["reupload_scene"] is None


def test_captured_steps_spans_and_counters(monkeypatch):
    monkeypatch.setattr(prr.CapturedSteps, "_record", record_eagerly)
    monkeypatch.setattr(prr.kernels, "library", lambda: None)
    r = Renderer("cornell", config=RenderConfig(width=8, height=6,
                                                max_depth=1), device="cpu")
    r.steps = prr.CapturedSteps("cpu")
    before = counters()
    m = _mark()
    with tracing():
        for _ in range(2):
            r.render_frame()
            r.present()
    tree, _ = _tree(m)
    for name in ("steps.key", "steps.replay", "steps.outputs"):
        assert tree[name] == ["render_frame", "present"] * 2, name
    assert tree["steps.capture"] == ["render_frame", "present"]
    assert tree["steps.feed"] == ["render_frame", "present"]
    after = counters()
    assert after["captures"] - before.get("captures", 0) == 2
    ms = [ms for _, ms in r.steps.captures]
    assert after["capture_ms"] - before.get("capture_ms", 0) == \
        pytest.approx(sum(ms))


def test_record_chunks_spans():
    cfg = RenderConfig(width=8, height=6, max_depth=1, spp=3, batch=2,
                       fps=10)
    r = Renderer("cornell", config=cfg, device="cpu")
    progress = []

    def on_progress(done, total):
        with span("caller") as c:
            progress.append(c.id)

    m = _mark()
    before = counters()
    with tracing():
        frames = VideoRecorder(r).record_chunks(cfg, 4, 2, on_progress)
    assert len(frames) == 2
    tree, mine = _tree(m)
    by_id = {s.id: s for s in mine}
    rec = [s for s in mine if s.name == "record.frame"]
    assert [s.frame for s in rec] == [4, 5]
    assert all(s.parent == 0 for s in rec)
    # The wait for frame 4's encode is inside frame 5's span; the last
    # frame's wait follows the loop.
    waits = [s for s in mine if s.name == "record.png"]
    assert tree["record.png"] == ["record.frame", ""]
    assert [s.frame for s in waits] == [4, 5]
    assert by_id[waits[0].parent].frame == 5
    # Each encode on the encode thread, at its top, before its wait ends.
    encodes = [s for s in mine if s.name == "record.png.encode"]
    assert tree["record.png.encode"] == ["", ""]
    assert [s.frame for s in encodes] == [4, 5]
    assert len({s.thread for s in encodes}) == 1
    assert encodes[0].thread != threading.get_native_id()
    for enc, wait in zip(encodes, waits):
        assert enc.end_ns <= wait.end_ns
    assert tree["caller"] == ["", ""]
    for fid, wait, caller in zip(rec, waits, progress):
        assert by_id[caller].start_ns >= fid.end_ns
        assert by_id[caller].start_ns >= wait.end_ns
    after = counters()
    assert after["png_encodes"] - before.get("png_encodes", 0) == 2
    assert 0 <= after.get("png_waits", 0) - before.get("png_waits", 0) <= 2
    for name in ("record.tick", "reupload_scene", "record.samples"):
        assert "record.frame" in tree[name], name
    assert tree["record.tick_start"] == ["record.frame"]   # one next frame
    # The batch controller picks the batches' sizes from their times.
    batches = len(tree["record.batch"])
    assert batches >= 2
    assert tree["record.batch"] == ["record.samples"] * batches
    assert tree["record.sync"] == ["record.batch"] * batches
    assert tree["render_frame"].count("record.batch") == 2 * 3
    assert tree["present"].count("record.frame") == 2
    assert tree["bridge.update"] == [""]
    worker = next(s for s in mine if s.name == "bridge.update")
    assert worker.thread != threading.get_native_id()
