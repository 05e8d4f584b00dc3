"""The recorder's pipelined PNG encode (`render/recorder.record_chunks`),
on the CPU.

Frame k's PNG is encoded on one thread owned by the call while frame k+1
ticks, uploads and renders its samples:

- the frames are, byte for byte and in order, `png_rgb` of each image
  `present` returned, with their index, timestamp and key-frame flag;
- an abort set from `on_progress` still finishes the frame whose samples
  were rendered: returned frames, progress calls and rendered frames are
  the same frames, each call after its frame's bytes exist;
- an encode that raises raises from `record_chunks`, and no encode thread
  outlives the call;
- a slow encode runs on another thread beside the next frame's
  `record.samples`, and the counters count every encode.
"""

import collections
import threading
import time

import pytest

from webgpu_raytracer_tpu_torch import Renderer, RenderConfig
from webgpu_raytracer_tpu_torch.render import recorder
from webgpu_raytracer_tpu_torch.render.recorder import (AbortFlag,
                                                        VideoRecorder)
from webgpu_raytracer_tpu_torch.utils.images import png_rgb
from webgpu_raytracer_tpu_torch.utils.profiling import (counters, span,
                                                        spans, tracing)

CFG = dict(width=16, height=12, max_depth=2, shader_spp=1, fps=10, spp=3,
           batch=2)
WARMUP = VideoRecorder.TAA_WARMUP_FRAMES


@pytest.fixture
def renderer():
    return Renderer("cornell", config=RenderConfig(**CFG), device="cpu")


def _encode_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("record.png")]


def test_frames_are_the_presented_images_encoded(renderer, monkeypatch):
    shown = []
    present = renderer.present

    def keep():
        img = present()
        shown.append(img.copy())
        return img

    monkeypatch.setattr(renderer, "present", keep)
    frames = VideoRecorder(renderer).record_chunks(renderer.config, 8, 4)
    assert len(shown) == WARMUP + 4
    assert [f.data for f in frames] == [png_rgb(i) for i in shown[WARMUP:]]
    assert [f.frame_index for f in frames] == [8, 9, 10, 11]
    assert [f.timestamp_us for f in frames] == [800_000, 900_000,
                                                1_000_000, 1_100_000]
    assert [f.key_frame for f in frames] == [False, False, True, False]
    assert not _encode_threads()


@pytest.mark.parametrize("stop_at", [1, 2, 5])
def test_abort_from_on_progress_reports_every_rendered_frame(
        renderer, monkeypatch, stop_at):
    uploads = [0]
    rendered = collections.Counter()   # render_frame calls by upload
    upload, render = renderer.reupload_scene, renderer.render_frame

    def counted_upload(*a, **kw):
        uploads[0] += 1
        return upload(*a, **kw)

    def counted_render(*a, **kw):
        rendered[uploads[0]] += 1
        return render(*a, **kw)

    encoded = []

    def keep_png(img):
        data = png_rgb(img)
        encoded.append(data)
        return data

    monkeypatch.setattr(renderer, "reupload_scene", counted_upload)
    monkeypatch.setattr(renderer, "render_frame", counted_render)
    monkeypatch.setattr(recorder, "png_rgb", keep_png)
    abort = AbortFlag()
    calls = []

    def on_progress(done, total):
        assert total == 6
        assert len(encoded) >= done     # this frame's bytes are final
        calls.append(done)
        if done == stop_at:
            abort.abort()

    frames = VideoRecorder(renderer).record_chunks(renderer.config, 0, 6,
                                                   on_progress, abort)
    # The bootstrap's upload, then one a recorded frame.
    assert rendered.pop(1) == WARMUP
    assert all(n == CFG["spp"] for n in rendered.values())
    samples = sorted(u - 2 for u in rendered)
    done = min(stop_at + 1, 6)    # the frame rendered when abort was set
    assert samples == list(range(done))
    assert sum(rendered.values()) == len(frames) * CFG["spp"]
    assert [f.frame_index for f in frames] == samples
    assert calls == list(range(1, done + 1))
    assert [f.data for f in frames] == encoded
    assert not _encode_threads()


@pytest.mark.parametrize("frame_count", [1, 3])
def test_encode_error_raises_and_leaves_no_thread(renderer, monkeypatch,
                                                  frame_count):
    def fail(img):
        raise ValueError("encode failed")

    monkeypatch.setattr(recorder, "png_rgb", fail)
    with pytest.raises(ValueError, match="encode failed"):
        VideoRecorder(renderer).record_chunks(renderer.config, 0,
                                              frame_count)
    renderer.bridge.wait()
    assert not _encode_threads()


def test_slow_encode_overlaps_next_frames_samples(renderer, monkeypatch):
    def slow(img):
        time.sleep(0.3)
        return png_rgb(img)

    monkeypatch.setattr(recorder, "png_rgb", slow)
    with tracing():
        with span("mark") as mark:
            pass
    before = counters()
    with tracing():
        frames = VideoRecorder(renderer).record_chunks(renderer.config, 0, 3)
    after = counters()
    assert len(frames) == 3
    mine = [s for s in spans() if s.id > mark.id]
    encodes = {s.frame: s for s in mine if s.name == "record.png.encode"}
    samples = {s.frame: s for s in mine if s.name == "record.samples"}
    assert sorted(encodes) == sorted(samples) == [0, 1, 2]
    main = threading.get_native_id()
    assert all(s.thread != main for s in encodes.values())
    assert all(s.thread == main for s in samples.values())
    for k in (0, 1):
        enc, nxt = encodes[k], samples[k + 1]
        assert enc.start_ns < nxt.end_ns and nxt.start_ns < enc.end_ns, k
    assert after["png_encodes"] - before.get("png_encodes", 0) == 3
    assert 1 <= after.get("png_waits", 0) - before.get("png_waits", 0) <= 3
    assert not _encode_threads()
