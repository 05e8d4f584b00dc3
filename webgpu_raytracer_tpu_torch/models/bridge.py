"""Async world bridge: scene compilation off the render thread.

The port's copy of the JAX package's `models/bridge.py`. Capability
parity with the reference's Web Worker bridge (src/world-bridge.ts +
src/worker/wasm-worker.ts): the native scene compiler runs on a dedicated
thread so the next frame's update (animation -> skinning -> BLAS -> TLAS ->
flatten) overlaps the device rendering the current frame — the overlap
pattern of VideoRecorder.ts:183-227. ctypes calls release the GIL, so the
C++ update genuinely runs in parallel with Python-side dispatch.

The bridge hands back snapshot numpy buffers (the reference `.slice()`-copies
WASM memory for the same reason: the source mutates on the next update).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Optional

from ..utils.profiling import span
from .native import NativeWorld


class WorldBridge:
    """Owns a NativeWorld on a worker thread; async update + cached reads."""

    def __init__(self, scene_name: str = "cornell",
                 obj_source: Optional[str] = None,
                 glb_data: Optional[bytes] = None):
        self._lock = threading.Lock()
        self._pending: Optional[Future] = None
        self._thread: Optional[threading.Thread] = None
        self.world = NativeWorld(scene_name, obj_source, glb_data)
        self.has_new_data = True  # dirty flag (world-bridge.ts caching)

    # -- async update (INIT/UPDATE protocol analogue) -----------------------

    def update_async(self, time: float) -> Future:
        """Kick a scene update on the worker thread; returns a Future that
        resolves when the flat buffers are ready to upload. The update is a
        `bridge.update` span on the worker thread."""
        with self._lock:
            if self._pending is not None and not self._pending.done():
                raise RuntimeError("previous update still in flight")
            fut: Future = Future()
            self._pending = fut

        def run():
            try:
                with span("bridge.update"):
                    self.world.update(time)
                self.has_new_data = True
                fut.set_result(True)
            except Exception as e:  # surfaced like console_error_panic_hook
                fut.set_exception(e)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return fut

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the in-flight update (if any) completes."""
        with self._lock:
            fut = self._pending
        if fut is None:
            return True
        return bool(fut.result(timeout))

    def update(self, time: float) -> None:
        """Synchronous update (UPDATE + wait)."""
        self.update_async(time)
        self.wait()

    # -- passthroughs --------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.world, name)
