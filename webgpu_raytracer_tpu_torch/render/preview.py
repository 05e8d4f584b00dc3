"""Live preview surface: MJPEG-over-HTTP progressive view of a render.

The port of the JAX package's `render/preview.py`; frames are JPEG-encoded
without Pillow (`utils/images.jpeg_rgb`, quality 85). The reference
presents every rAF tick to a live canvas (src/main.ts:119-181); the CLI
analogue serves the presented LDR frames as a
multipart/x-mixed-replace JPEG stream that any browser <img> renders as a
live, progressively-converging view. Zero cost when not enabled: the server
only exists when `cli render --preview` constructs it, and `publish` is a
JPEG encode + condition-variable notify (throttled to ~10 Hz by the
caller).

Endpoints:
  /        minimal HTML page with the <img> viewer + 1 Hz stats line
  /stream  the MJPEG stream (one part per published frame)
  /stats   latest stats line as text/plain (polled by the page)
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.images import jpeg_rgb

_PAGE = b"""<!doctype html>
<html><head><title>webgpu_raytracer_tpu_torch preview</title>
<style>body{background:#111;color:#ddd;font:13px monospace;margin:0;
text-align:center}img{image-rendering:pixelated;margin-top:8px;
max-width:98vw}#s{padding:6px}</style></head>
<body><div id="s">connecting...</div><img src="/stream">
<script>setInterval(async()=>{try{
document.getElementById('s').textContent=
await (await fetch('/stats')).text();}catch(e){}},1000);</script>
</body></html>"""


class PreviewServer:
    """Threaded MJPEG preview server; `publish` hands it presented frames."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._cond = threading.Condition()
        self._jpeg: bytes | None = None
        self._seq = 0
        self._stats = b"waiting for first frame"
        self._closed = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/stream":
                    outer._serve_stream(self)
                elif self.path == "/stats":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.end_headers()
                    self.wfile.write(outer._stats)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- producer side -------------------------------------------------------

    def publish(self, img, stats: str | None = None):
        """Encode one (H, W, 3) uint8 frame and wake all stream clients."""
        jpeg = jpeg_rgb(img, quality=85)
        with self._cond:
            self._jpeg = jpeg
            self._seq += 1
            if stats is not None:
                self._stats = stats.encode()
            self._cond.notify_all()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- per-client stream loop ----------------------------------------------

    def _serve_stream(self, handler: BaseHTTPRequestHandler):
        handler.send_response(200)
        handler.send_header(
            "Content-Type", "multipart/x-mixed-replace; boundary=frame")
        handler.end_headers()
        last = 0
        while True:
            with self._cond:
                while self._seq == last and not self._closed:
                    self._cond.wait(timeout=1.0)
                if self._closed:
                    return
                jpeg, last = self._jpeg, self._seq
            if jpeg is None:
                continue
            try:
                handler.wfile.write(b"--frame\r\n"
                                    b"Content-Type: image/jpeg\r\n"
                                    b"Content-Length: "
                                    + str(len(jpeg)).encode() + b"\r\n\r\n")
                handler.wfile.write(jpeg)
                handler.wfile.write(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                return  # client went away
