"""Multi-host render farm: coordinator (job queue) + render workers over TCP.

The port's copy of the JAX package's `parallel/cluster.py`. Its workers
build the port's `Renderer` on their `device` ("cuda" unless asked). The
frame-sharding tier above the per-frame SPMD kernels — functional parity
with the reference's distributed system (SURVEY.md §2.5/§5.3):

Coordinator  (reference signaling-server/server.ts + DistributedHost.ts):
- shared-secret auth with constant-time compare (server.ts:150-189)
- worker registry + session resumption via sessionId/sessionToken pairs
  (server.ts:240-289); a resumed worker reclaims its in-flight job
- job queue of {start, count} frame batches, dynamic work stealing
  (DistributedHost.ts:6-13, main.ts:279-306)
- worker FSM idle/loading/busy; late joiners get the cached scene
  (DistributedHost.ts:190-216); NEED_SCENE resync (:218-261)
- 30 s grace period holding a disconnected worker's job before requeueing
  (:18-22,150-170)
- duplicate-result dedupe by start frame (:282-290)
- completion -> frame-ordered mux + output (:312-356)
- admin status snapshot + 100-entry log ring + worker kick
  (server.ts:16-39,41-113)

Worker (reference DistributedWorker.ts): scene receive -> config apply ->
renderer rebuild -> SCENE_LOADED; render requests queued while loading;
abortable execution; buffered-result retry on reconnect.
"""

from __future__ import annotations

import functools
import hmac
import queue
import secrets
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..config import RenderConfig
from . import protocol as P
from .protocol import Message

GRACE_PERIOD_S = 30.0
LOG_RING = 100
SEND_TIMEOUT_S = 60.0  # per-socket write timeout (slow/congested worker)
OUTBOX_MAX = 64        # queued messages per worker before backpressure trips

# Outbox sentinel: the sender thread closes the socket and exits.
_CLOSE = object()

# Admin console page (reference signaling-server/admin.html): live status,
# worker table with kick buttons, log tail; polls /admin/api/status at 2 s.
_ADMIN_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>render farm admin</title>
<style>
 body{font:14px monospace;background:#111;color:#ddd;margin:2em}
 h1{font-size:18px} table{border-collapse:collapse;margin:1em 0}
 td,th{border:1px solid #444;padding:4px 10px;text-align:left}
 .idle{color:#6c6}.busy{color:#fc6}.lost{color:#f66}.loading{color:#6cf}
 #log{white-space:pre;background:#000;padding:1em;max-height:20em;
      overflow-y:auto;border:1px solid #333}
 button{background:#311;color:#f88;border:1px solid #633;cursor:pointer}
</style></head><body>
<h1>render farm</h1>
<div id="summary">loading&hellip;</div>
<table id="workers"><tr><th>id</th><th>status</th><th>job</th><th></th></tr>
</table>
<div id="log"></div>
<script>
async function kick(id){
  await fetch('/admin/api/kick?id='+id,{method:'POST'});refresh();}
async function refresh(){
  try{
    const s=await (await fetch('/admin/api/status')).json();
    document.getElementById('summary').textContent=
      `queue: ${s.queue} | results: ${s.results}/${s.expected} | `+
      `workers: ${s.workers.length}`;
    const t=document.getElementById('workers');
    t.innerHTML='<tr><th>id</th><th>status</th><th>job</th><th></th></tr>';
    for(const w of s.workers){
      const r=t.insertRow();
      r.insertCell().textContent=w.id;
      const c=r.insertCell();c.textContent=w.status;c.className=w.status;
      r.insertCell().textContent=w.job?`${w.job.start}+${w.job.count}`:'-';
      const b=document.createElement('button');b.textContent='kick';
      b.onclick=()=>kick(w.id);r.insertCell().appendChild(b);
    }
    document.getElementById('log').textContent=s.log.join('\\n');
  }catch(e){document.getElementById('summary').textContent='error: '+e;}
}
refresh();setInterval(refresh,2000);
</script></body></html>
"""


@dataclass
class Job:
    start: int
    count: int


@dataclass
class WorkerState:
    worker_id: int
    session_id: str
    session_token: str
    sock: Optional[socket.socket] = None
    status: str = "connecting"  # connecting|loading|idle|busy|lost
    job: Optional[Job] = None
    lost_at: Optional[float] = None
    has_scene: bool = False
    # Per-connection outbox drained by a dedicated sender thread: ALL
    # coordinator->worker writes (incl. multi-MB scene payloads) happen
    # outside the FSM lock, so one slow/congested worker never stalls
    # assignment, status, or the admin API (the reference's bulk path
    # likewise yields/backpressures, RtcClient.ts:201-232).
    outbox: Optional["queue.Queue"] = None


class Coordinator:
    """Render-farm host: owns the job queue and collects results."""

    def __init__(self, secret: str = "", host: str = "127.0.0.1",
                 port: int = 0, grace_period_s: float = GRACE_PERIOD_S,
                 send_timeout_s: float = SEND_TIMEOUT_S):
        self.secret = secret
        self.grace_period_s = grace_period_s
        self.send_timeout_s = send_timeout_s
        self._lock = threading.RLock()
        self._workers: Dict[int, WorkerState] = {}
        self._sessions: Dict[str, WorkerState] = {}
        self._next_worker_id = 1
        self._queue: deque[Job] = deque()
        self._results: Dict[int, list] = {}  # start_frame -> frames
        self._expected_jobs = 0
        self._scene: Optional[dict] = None
        self._scene_payload: bytes = b""
        self._log: deque[str] = deque(maxlen=LOG_RING)
        self._done = threading.Event()
        self._stop = False

        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        self._reaper = threading.Thread(target=self._grace_reaper, daemon=True)
        self._reaper.start()

    # -- public API ----------------------------------------------------------

    def log(self, msg: str):
        with self._lock:
            self._log.append(f"{time.strftime('%H:%M:%S')} {msg}")

    def set_scene(self, config: RenderConfig, scene_name: str,
                  payload: bytes = b"", file_type: Optional[str] = None):
        """Cache the scene for broadcast to current and late-joining workers
        (DistributedHost.sendSceneHelper)."""
        with self._lock:
            self._scene = {
                "config": config.to_dict(),
                "scene_name": scene_name,
                "file_type": file_type,
            }
            self._scene_payload = payload
            for w in self._workers.values():
                if w.sock is not None:
                    self._send_scene(w)

    def start_render(self, total_frames: int, job_batch: int):
        """Build the job queue (main.ts:279-306) and start assigning."""
        with self._lock:
            self._queue.clear()
            self._results.clear()
            self._done.clear()
            start = 0
            n = 0
            while start < total_frames:
                count = min(job_batch, total_frames - start)
                self._queue.append(Job(start, count))
                start += count
                n += 1
            self._expected_jobs = n
            self.log(f"render start: {total_frames} frames, {n} jobs")
            self._assign_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def collect_frames(self):
        """All received frames, frame-ordered and deduped."""
        with self._lock:
            frames = [f for lst in self._results.values() for f in lst]
        seen = {}
        for f in frames:
            seen.setdefault(f.frame_index, f)
        return [seen[k] for k in sorted(seen)]

    def admin_status(self) -> dict:
        """Status snapshot (signaling-server admin API analogue)."""
        with self._lock:
            return {
                "workers": [
                    {
                        "id": w.worker_id,
                        "status": w.status,
                        "job": None if w.job is None else
                        {"start": w.job.start, "count": w.job.count},
                        "has_scene": w.has_scene,
                    }
                    for w in self._workers.values()
                ],
                "queue": len(self._queue),
                "results": len(self._results),
                "expected": self._expected_jobs,
                "log": list(self._log),
            }

    def kick(self, worker_id: int):
        with self._lock:
            w = self._workers.get(worker_id)
            if w and w.sock:
                self._send(w, Message(P.KICK, {}))
                self._send(w, _CLOSE)  # sender closes after the KICK drains

    def stop_render(self):
        with self._lock:
            self._queue.clear()
            for w in self._workers.values():
                if w.sock:
                    self._send(w, Message(P.STOP_RENDER, {}))

    def start_admin(self, host: str = "127.0.0.1", port: int = 0,
                    username: str = "admin", password: str = "") -> int:
        """HTTP admin console (reference server.ts:41-113 + admin.html):
        GET /admin/api/status -> JSON snapshot; POST /admin/api/kick?id=N.
        Basic auth when a password is set. Returns the bound port."""
        import base64
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        coord = self
        expect = None
        if password:
            expect = "Basic " + base64.b64encode(
                f"{username}:{password}".encode()).decode()

        class Handler(BaseHTTPRequestHandler):
            def _authed(self):
                if expect is None:
                    return True
                if self.headers.get("Authorization") == expect:
                    return True
                self.send_response(401)
                self.send_header("WWW-Authenticate", "Basic realm=admin")
                self.end_headers()
                return False

            def _json(self, code, obj):
                body = _json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if not self._authed():
                    return
                if self.path == "/admin/api/status":
                    self._json(200, coord.admin_status())
                elif self.path in ("/", "/admin"):
                    body = _ADMIN_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if not self._authed():
                    return
                if self.path.startswith("/admin/api/kick"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    wid = int(q.get("id", ["-1"])[0])
                    coord.kick(wid)
                    coord.log(f"admin kicked worker {wid}")
                    self._json(200, {"kicked": wid})
                else:
                    self._json(404, {"error": "not found"})

            def log_message(self, *args):
                pass

        self._admin_srv = ThreadingHTTPServer((host, port), Handler)
        self.admin_port = self._admin_srv.server_address[1]
        threading.Thread(target=self._admin_srv.serve_forever,
                         daemon=True).start()
        return self.admin_port

    def close(self):
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass
        admin = getattr(self, "_admin_srv", None)
        if admin is not None:
            admin.shutdown()
        with self._lock:
            for w in self._workers.values():
                if w.sock:
                    try:
                        w.sock.close()
                    except OSError:
                        pass

    # -- internals ------------------------------------------------------------

    def _accept_loop(self):
        while not self._stop:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True).start()

    def _auth_ok(self, token: str) -> bool:
        if not self.secret:
            return True
        return hmac.compare_digest(token or "", self.secret)

    def _serve_conn(self, sock: socket.socket):
        msg = P.recv_message(sock)
        if msg is None or msg.type != P.HELLO:
            sock.close()
            return
        if not self._auth_ok(msg.body.get("token", "")):
            try:
                P.send_message(sock, Message(P.REJECT, {"reason": "auth"}))
            finally:
                sock.close()
            return

        with self._lock:
            sid = msg.body.get("session_id")
            stok = msg.body.get("session_token")
            w = None
            if sid and sid in self._sessions:
                cand = self._sessions[sid]
                if hmac.compare_digest(cand.session_token, stok or ""):
                    w = cand  # session resumption (server.ts:240-289)
                    self.log(f"worker {w.worker_id} resumed")
            if w is None:
                w = WorkerState(
                    worker_id=self._next_worker_id,
                    session_id=secrets.token_hex(8),
                    session_token=secrets.token_hex(16),
                )
                self._next_worker_id += 1
                self._workers[w.worker_id] = w
                self._sessions[w.session_id] = w
                self.log(f"worker {w.worker_id} joined")
            w.sock = sock
            w.lost_at = None
            w.has_scene = bool(msg.body.get("has_scene", False))
            self._attach_sender(w, sock)
            this_outbox = w.outbox  # this connection's queue (for cleanup)
            self._send(w, Message(P.WELCOME, {
                "worker_id": w.worker_id,
                "session_id": w.session_id,
                "session_token": w.session_token,
            }))
            if self._scene is not None and not w.has_scene:
                self._send_scene(w)
            elif w.job is not None:
                # resumed with its job intact: let it keep going
                w.status = "busy"
            else:
                w.status = "idle" if w.has_scene else "loading"
                self._assign_all()

        try:
            while True:
                m = P.recv_message(sock)
                if m is None:
                    break
                self._handle(w, m)
        except OSError:
            pass
        finally:
            with self._lock:
                if w.sock is sock:
                    w.sock = None
                    w.status = "lost"
                    w.lost_at = time.monotonic()
                    self.log(f"worker {w.worker_id} lost"
                             + (f" (job {w.job.start})" if w.job else ""))
            try:  # release THIS connection's sender thread (it may be
                # blocked on q.get; a resumed connection has its own queue).
                # A full queue means the sender is alive and draining, so a
                # short blocking put always lands; if the sender already
                # exited via _send_failed there is no thread to release.
                this_outbox.put(_CLOSE, timeout=1.0)
            except queue.Full:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # -- outbound path (per-worker sender threads) ----------------------------

    def _attach_sender(self, w: WorkerState, sock: socket.socket):
        """One sender thread + bounded outbox per connection. Caller holds
        the lock; every enqueued message is sent in order by the thread."""
        sock.settimeout(self.send_timeout_s)
        w.outbox = queue.Queue(maxsize=OUTBOX_MAX)
        threading.Thread(target=self._sender_loop, args=(w, sock, w.outbox),
                         daemon=True).start()

    def _sender_loop(self, w: WorkerState, sock: socket.socket,
                     q: "queue.Queue"):
        while True:
            msg = q.get()
            if msg is _CLOSE or w.sock is not sock:
                try:
                    sock.close()
                except OSError:
                    pass
                return
            try:
                P.send_message(sock, msg)
            except (OSError, ValueError):
                # write failure or timeout: drop the connection; requeue the
                # in-flight job immediately (DistributedHost.ts:132-139).
                self._send_failed(w, sock)
                return

    def _send(self, w: WorkerState, msg) -> bool:
        """Enqueue a message for w's sender thread. Never blocks: a full
        outbox means the worker is not draining (backpressure) and is
        treated as a send failure."""
        q = w.outbox
        if w.sock is None or q is None:
            return False
        try:
            q.put_nowait(msg)
            return True
        except queue.Full:
            self._send_failed(w, w.sock)
            return False

    def _send_failed(self, w: WorkerState, sock):
        if self._stop:
            return
        with self._lock:
            if w.sock is not sock:
                return
            try:
                sock.close()  # unblocks the recv loop -> marks it lost
            except OSError:
                pass
            self.log(f"send to worker {w.worker_id} failed"
                     + (f" (job {w.job.start} requeued)" if w.job else ""))
            if w.job is not None and w.job.start not in self._results:
                self._queue.appendleft(w.job)
            w.job = None
            w.status = "lost"
            w.lost_at = time.monotonic()
            self._assign_all()

    def _send_scene(self, w: WorkerState):
        """Enqueue the scene broadcast (metadata frame + bulk payload frame).
        The multi-MB payload is written by the worker's sender thread, NOT
        under the FSM lock."""
        w.status = "loading"
        if self._send(w, Message(P.SCENE, dict(self._scene))):
            self._send(w, Message(
                "scene_payload", {"total_bytes": len(self._scene_payload)},
                self._scene_payload))

    def _handle(self, w: WorkerState, m: Message):
        with self._lock:
            if m.type == P.SCENE_LOADED:
                w.status = "idle"
                w.has_scene = True
                self.log(f"worker {w.worker_id} scene loaded")
                self._assign_all()
            elif m.type == P.NEED_SCENE:
                if self._scene is not None:
                    self._send_scene(w)
            elif m.type == P.WORKER_STATUS:
                w.status = m.body.get("status", w.status)
            elif m.type == P.RENDER_RESULT:
                start = int(m.body.get("start", -1))
                frames = P.unpack_frames(m.body.get("frames", []), m.payload)
                if start in self._results:
                    self.log(f"duplicate result for job {start} ignored")
                else:
                    self._results[start] = frames
                    self.log(f"job {start} done by worker {w.worker_id}"
                             f" ({len(frames)} frames)")
                w.job = None
                w.status = "idle"
                if len(self._results) >= self._expected_jobs and \
                        self._expected_jobs > 0:
                    self._done.set()
                self._assign_all()
            elif m.type == P.PING:
                self._send(w, Message(P.PONG, {}))

    def _assign_all(self):
        for w in self._workers.values():
            if (w.status == "idle" and w.sock is not None and w.job is None
                    and self._queue):
                job = self._queue.popleft()
                w.job = job
                w.status = "busy"
                if self._send(w, Message(P.RENDER_REQUEST, {
                        "start": job.start, "count": job.count})):
                    self.log(f"job {job.start} -> worker {w.worker_id}")
                elif w.job is job:
                    # enqueue failed and _send_failed didn't requeue it
                    self._queue.appendleft(job)
                    w.job = None
                    w.status = "lost"
                    w.lost_at = time.monotonic()

    def _grace_reaper(self):
        """Requeue in-flight jobs of workers lost past the grace period."""
        while not self._stop:
            time.sleep(min(1.0, self.grace_period_s / 4 or 0.1))
            with self._lock:
                now = time.monotonic()
                for w in self._workers.values():
                    if (w.status == "lost" and w.job is not None
                            and w.lost_at is not None
                            and now - w.lost_at > self.grace_period_s):
                        if w.job.start not in self._results:
                            self.log(f"grace expired: requeue job "
                                     f"{w.job.start} from worker {w.worker_id}")
                            self._queue.appendleft(w.job)
                        w.job = None
                self._assign_all()


class WorkerClient:
    """Render worker: executes frame-batch jobs against a local Renderer."""

    def __init__(self, host: str, port: int, secret: str = "",
                 renderer_factory: Optional[Callable] = None,
                 session: Optional[tuple] = None, device="cuda"):
        self.host = host
        self.port = port
        self.secret = secret
        self.renderer_factory = renderer_factory or functools.partial(
            _default_renderer_factory, device=device)
        self.session = session  # (session_id, session_token) for resumption
        self._sock: Optional[socket.socket] = None
        self._recorder = None
        self._renderer = None
        self._config: Optional[RenderConfig] = None
        self._scene_meta: Optional[dict] = None
        self._scene_payload = b""
        self._pending_jobs: deque = deque()  # queued while scene loading
        self._unsent_results: List[Message] = []  # buffered retry list
        self._abort = None
        self._stop = False
        self.worker_id = None

    def connect(self):
        self._sock = socket.create_connection((self.host, self.port))
        body = {"role": "worker", "token": self.secret,
                "has_scene": self._renderer is not None}
        if self.session:
            body["session_id"], body["session_token"] = self.session
        P.send_message(self._sock, Message(P.HELLO, body))
        m = P.recv_message(self._sock)
        if m is None or m.type != P.WELCOME:
            raise ConnectionError("rejected by coordinator")
        self.worker_id = m.body["worker_id"]
        self.session = (m.body["session_id"], m.body["session_token"])
        # flush buffered results (DistributedWorker.ts:131-146)
        for msg in self._unsent_results:
            P.send_message(self._sock, msg)
        self._unsent_results.clear()

    def run(self):
        """Message loop; returns when the connection drops or KICKed."""
        while not self._stop:
            m = P.recv_message(self._sock)
            if m is None:
                return
            if m.type == P.SCENE:
                self._scene_meta = m.body
            elif m.type == "scene_payload":
                self._scene_payload = m.payload
                self._load_scene()
            elif m.type == P.RENDER_REQUEST:
                if self._renderer is None:
                    if self._scene_meta is None:
                        P.send_message(self._sock, Message(P.NEED_SCENE, {}))
                    self._pending_jobs.append(m.body)
                else:
                    self._execute(m.body)
            elif m.type == P.STOP_RENDER:
                if self._abort is not None:
                    self._abort.abort()
            elif m.type == P.KICK:
                return

    def close(self):
        self._stop = True
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    # -- internals ------------------------------------------------------------

    def _load_scene(self):
        """Apply config + rebuild renderer (DistributedWorker.ts:182-226)."""
        meta = self._scene_meta
        self._config = RenderConfig.from_dict(meta["config"])
        self._renderer = self.renderer_factory(
            self._config, meta.get("scene_name", "viewer"),
            meta.get("file_type"), self._scene_payload)
        from ..render.recorder import VideoRecorder

        self._recorder = VideoRecorder(self._renderer)
        P.send_message(self._sock, Message(P.SCENE_LOADED, {}))
        while self._pending_jobs:
            self._execute(self._pending_jobs.popleft())

    def _execute(self, job: dict):
        from ..render.recorder import AbortFlag

        start, count = int(job["start"]), int(job["count"])
        self._abort = AbortFlag()
        frames = self._recorder.record_chunks(
            self._config, start_frame=start, frame_count=count,
            abort=self._abort)
        if self._abort.aborted:
            return
        meta, blob = P.pack_frames(frames)
        msg = Message(P.RENDER_RESULT, {"start": start, "count": count,
                                        "frames": meta}, blob)
        try:
            P.send_message(self._sock, msg)
        except OSError:
            self._unsent_results.append(msg)  # retry after reconnect


def _default_renderer_factory(config: RenderConfig, scene_name: str,
                              file_type: Optional[str], payload: bytes,
                              device="cuda"):
    from ..render.renderer import Renderer

    obj_source = None
    glb_data = None
    if file_type == "obj" and payload:
        obj_source = payload.decode()
    elif file_type in ("glb", "vrm") and payload:
        glb_data = payload
    r = Renderer(scene_name, obj_source=obj_source, glb_data=glb_data,
                 config=config, device=device)
    r.build_pipeline(config.max_depth, config.shader_spp)
    return r
