"""The port's render farm (`parallel/protocol.py`, `parallel/cluster.py`):
twins of tests/test_cluster.py and of
tests/test_app_shell.py::test_worker_single_client_reconnect_resumes.

Real localhost TCP with fake renderers (no device work): auth, scene
broadcast, assignment, dedupe, grace-period requeue, session resumption,
late-join scene sync, the admin console, a worker that stops reading, and
the frame pack. The wire format is the JAX package's: a port worker
serves a JAX coordinator. End to end, two `WorkerClient(device="cpu")`
workers with the port's `Renderer` and `VideoRecorder` give frames byte-
equal to a solo `record_chunks` (frames are independent of the job split:
every frame resets its accumulation and the RNG is counter-seeded).
"""

import base64
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from webgpu_raytracer_tpu.parallel.cluster import \
    Coordinator as JaxCoordinator
from webgpu_raytracer_tpu_torch.config import RenderConfig
from webgpu_raytracer_tpu_torch.parallel import protocol as P
from webgpu_raytracer_tpu_torch.parallel.cluster import (
    Coordinator, WorkerClient, _default_renderer_factory)
from webgpu_raytracer_tpu_torch.render.recorder import (EncodedFrame,
                                                        VideoRecorder)
from webgpu_raytracer_tpu_torch.utils.textures import decode_png


class FakeRenderer:
    def __init__(self, config):
        self.config = config


class FakeRecorder:
    """Deterministic fake frames, `delay` seconds each."""

    def __init__(self, renderer, delay=0.0):
        self.renderer = renderer
        self.delay = delay

    def record_chunks(self, config, start_frame=0, frame_count=None,
                      on_progress=None, abort=None):
        frames = []
        for k in range(frame_count):
            if abort is not None and abort.aborted:
                break
            if self.delay:
                time.sleep(self.delay)
            idx = start_frame + k
            frames.append(EncodedFrame(idx, idx * 33333, idx % 30 == 0,
                                       f"frame-{idx}".encode()))
        return frames


def make_worker(coord, secret="s3cret", delay=0.0, session=None):
    w = WorkerClient("127.0.0.1", coord.port, secret=secret,
                     renderer_factory=lambda config, *_: FakeRenderer(config),
                     session=session)
    orig_load = w._load_scene

    def load_scene():
        orig_load()
        w._recorder = FakeRecorder(w._renderer, delay=delay)

    w._load_scene = load_scene
    return w


def run_worker(w):
    t = threading.Thread(target=lambda: (w.connect(), w.run()), daemon=True)
    t.start()
    return t


@pytest.fixture
def coord():
    c = Coordinator(secret="s3cret", grace_period_s=0.5)
    yield c
    c.close()


def test_auth_rejects_bad_secret(coord):
    with pytest.raises(ConnectionError):
        make_worker(coord, secret="wrong").connect()


def test_basic_render_roundtrip(coord):
    coord.set_scene(RenderConfig(fps=30, duration=1.0, spp=4), "cornell")
    run_worker(make_worker(coord))
    time.sleep(0.3)
    coord.start_render(total_frames=30, job_batch=10)
    assert coord.wait(10.0)
    frames = coord.collect_frames()
    assert [f.frame_index for f in frames] == list(range(30))
    assert frames[7].data == b"frame-7"


def test_work_stealing_across_workers(coord):
    coord.set_scene(RenderConfig(fps=30, duration=2.0), "cornell")
    for _ in range(3):
        run_worker(make_worker(coord, delay=0.002))
    time.sleep(0.5)
    coord.start_render(total_frames=60, job_batch=5)
    assert coord.wait(20.0)
    assert len(coord.collect_frames()) == 60
    assert len(coord.admin_status()["workers"]) == 3


def test_grace_period_requeue(coord):
    coord.set_scene(RenderConfig(fps=30, duration=1.0), "cornell")
    slow = make_worker(coord, delay=0.5)
    run_worker(slow)
    time.sleep(0.3)
    coord.start_render(total_frames=20, job_batch=10)
    time.sleep(0.3)
    slow.close()  # dies mid-job
    run_worker(make_worker(coord))
    assert coord.wait(15.0), coord.admin_status()
    assert len(coord.collect_frames()) == 20


def test_duplicate_results_deduped(coord):
    coord.set_scene(RenderConfig(), "cornell")
    run_worker(make_worker(coord))
    time.sleep(0.3)
    coord.start_render(total_frames=10, job_batch=10)
    assert coord.wait(10.0)
    meta, blob = P.pack_frames([EncodedFrame(0, 0, True, b"dup")])
    with coord._lock:
        ws = list(coord._workers.values())[0]
    coord._handle(ws, P.Message(P.RENDER_RESULT,
                                {"start": 0, "frames": meta}, blob))
    assert coord.collect_frames()[0].data == b"frame-0"


def test_late_join_gets_scene(coord):
    coord.set_scene(RenderConfig(), "cornell")
    time.sleep(0.1)
    run_worker(make_worker(coord))
    deadline = time.time() + 5
    while time.time() < deadline:
        st = coord.admin_status()
        if st["workers"] and st["workers"][0]["has_scene"]:
            break
        time.sleep(0.05)
    assert coord.admin_status()["workers"][0]["has_scene"]


def test_session_resumption(coord):
    coord.set_scene(RenderConfig(), "cornell")
    w = make_worker(coord)
    run_worker(w)
    time.sleep(0.3)
    sid = w.session
    w.close()
    time.sleep(0.2)
    w2 = make_worker(coord, session=sid)
    run_worker(w2)
    time.sleep(0.3)
    assert w2.worker_id == w.worker_id
    assert len(coord.admin_status()["workers"]) == 1


def test_admin_status_and_log(coord):
    coord.set_scene(RenderConfig(), "cornell")
    run_worker(make_worker(coord))
    time.sleep(0.3)
    st = coord.admin_status()
    assert "log" in st and len(st["log"]) >= 1
    assert st["workers"][0]["status"] in ("idle", "loading")


def test_frame_pack_roundtrip():
    frames = [EncodedFrame(i, i * 1000, i == 0, bytes([i] * (i + 1)))
              for i in range(5)]
    out = P.unpack_frames(*P.pack_frames(frames))
    assert all(isinstance(b, EncodedFrame) for b in out)
    assert out == frames


def _auth(req):
    req.add_header("Authorization",
                   "Basic " + base64.b64encode(b"admin:pw").decode())
    return req


def test_http_admin_console(coord):
    port = coord.start_admin(password="pw")
    coord.set_scene(RenderConfig(), "cornell")
    run_worker(make_worker(coord))
    time.sleep(0.3)
    url = f"http://127.0.0.1:{port}/admin/api/status"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url, timeout=5)
    assert e.value.code == 401
    with urllib.request.urlopen(_auth(urllib.request.Request(url)),
                                timeout=5) as resp:
        st = json.loads(resp.read())
    assert len(st["workers"]) == 1
    wid = st["workers"][0]["id"]
    kick = _auth(urllib.request.Request(
        f"http://127.0.0.1:{port}/admin/api/kick?id={wid}", method="POST"))
    with urllib.request.urlopen(kick, timeout=5) as resp:
        assert json.loads(resp.read())["kicked"] == wid


def test_http_admin_page(coord):
    port = coord.start_admin(password="pw")
    req = _auth(urllib.request.Request(f"http://127.0.0.1:{port}/admin"))
    with urllib.request.urlopen(req, timeout=5) as resp:
        assert resp.headers["Content-Type"].startswith("text/html")
        body = resp.read().decode()
    assert "/admin/api/status" in body and "kick" in body


def test_slow_reader_does_not_block_fsm():
    """A worker that stops reading: the scene broadcast and the admin
    status return at once, a healthy worker completes the render, and the
    wedged one trips the send timeout and goes lost."""
    c = Coordinator(secret="s3cret", grace_period_s=0.5, send_timeout_s=1.5)
    try:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.connect(("127.0.0.1", c.port))
        P.send_message(s, P.Message(P.HELLO, {"token": "s3cret",
                                              "has_scene": False}))
        assert P.recv_message(s).type == P.WELCOME
        t0 = time.perf_counter()
        c.set_scene(RenderConfig(), "cornell", payload=bytes(64 << 20))
        assert time.perf_counter() - t0 < 0.5
        t0 = time.perf_counter()
        c.admin_status()
        assert time.perf_counter() - t0 < 0.5
        w = make_worker(c)
        run_worker(w)
        time.sleep(0.3)
        c.start_render(total_frames=8, job_batch=4)
        assert c.wait(15.0), c.admin_status()
        assert len(c.collect_frames()) == 8
        deadline = time.time() + 10
        while time.time() < deadline:
            slow = [x for x in c.admin_status()["workers"]
                    if x["id"] != w.worker_id]
            if slow and slow[0]["status"] == "lost":
                break
            time.sleep(0.1)
        else:
            raise AssertionError(c.admin_status())
        s.close()
    finally:
        c.close()


def test_worker_single_client_reconnect_resumes():
    """One WorkerClient whose connection drops mid-job reconnects, resumes
    its session and delivers the buffered result (the cli worker loop)."""
    coord = Coordinator(secret="s3cret", grace_period_s=5.0)
    try:
        coord.set_scene(RenderConfig(fps=30, duration=1.0, spp=4), "cornell")
        w = make_worker(coord, delay=0.04)

        def worker_loop():
            for _ in range(10):
                try:
                    w.connect()
                    w.run()
                except (ConnectionError, OSError):
                    pass
                if w._stop:
                    return
                time.sleep(0.1)

        threading.Thread(target=worker_loop, daemon=True).start()
        time.sleep(0.3)
        first_session = w.session
        assert first_session is not None
        coord.start_render(total_frames=30, job_batch=10)
        time.sleep(0.15)
        w._sock.close()
        assert coord.wait(20.0), "render did not complete after reconnect"
        assert [f.frame_index for f in coord.collect_frames()] == \
            list(range(30))
        assert w.session[0] == first_session[0]
        assert len(coord.admin_status()["workers"]) == 1
        w.close()
    finally:
        coord.close()


def test_port_worker_serves_jax_coordinator():
    """The wire format is unchanged: the JAX package's coordinator drives
    a port worker to the end of a render."""
    c = JaxCoordinator(secret="s3cret", grace_period_s=0.5)
    try:
        c.set_scene(RenderConfig(fps=10, duration=1.0), "cornell")
        run_worker(make_worker(c))
        time.sleep(0.3)
        c.start_render(total_frames=10, job_batch=4)
        assert c.wait(10.0), c.admin_status()
        frames = c.collect_frames()
        assert [f.data for f in frames] == [f"frame-{i}".encode()
                                            for i in range(10)]
    finally:
        c.close()


def test_worker_device_reaches_the_renderer():
    config = RenderConfig(width=8, height=8, max_depth=2)
    w = WorkerClient("127.0.0.1", 1, device="cpu")
    r = w.renderer_factory(config, "cornell", None, b"")
    assert r.device.type == "cpu" and (r.width, r.max_depth) == (8, 2)


def test_farm_end_to_end_with_real_renderer():
    """Coordinator + two WorkerClient(device="cpu") workers with the port's
    Renderer and VideoRecorder at 16x16, spp 1, depth 2, 4 frames in jobs
    of 2: the collected PNGs decode and equal a solo record_chunks byte
    for byte."""
    config = RenderConfig(width=16, height=16, max_depth=2, shader_spp=1,
                          spp=1, fps=4, duration=1.0)
    solo = VideoRecorder(_default_renderer_factory(
        config, "cornell", None, b"", device="cpu")).record_chunks(config, 0,
                                                                  4)
    assert len(solo) == 4
    c = Coordinator(secret="s3cret", grace_period_s=0.5)
    try:
        c.set_scene(config, "cornell")
        workers = [WorkerClient("127.0.0.1", c.port, secret="s3cret",
                                device="cpu") for _ in range(2)]
        for w in workers:
            run_worker(w)
        c.start_render(total_frames=4, job_batch=2)
        assert c.wait(300.0), c.admin_status()
        frames = c.collect_frames()
        assert [f.frame_index for f in frames] == [0, 1, 2, 3]
        for f, ref in zip(frames, solo):
            assert decode_png(f.data).shape == (16, 16, 3)
            assert f.data == ref.data, f.frame_index
        for w in workers:
            w.close()
    finally:
        c.close()
