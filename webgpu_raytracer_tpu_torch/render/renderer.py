"""Renderer facade: scene resources, accumulation state, history swap.

The port of the JAX package's `render/renderer.py`: `render_frame()`
traces one progressive frame into the accumulator through the CUDA kernels
(their plain versions on the CPU), and `present()` runs the post-process
chain. `choose_backend` (`ops/api.py`) picks the tracer, as in the JAX
package: "dense" on CUDA, and on the CPU up to 16,384 world triangles;
"bvh" above that on the CPU (`ops/trace.trace_pixels` over a
`DeviceScene`). A scene's textures are decoded, packed into the (level 0,
mip) quad-table pyramid and uploaded once, at construction; the BVH path
samples level 0 at every bounce. On the dense path every scene takes the
row-state loop (the shade kernel, which samples a textured scene's
pyramid itself; `ray_color_dense` serves `max_depth` 0);
`render_frame(use_gbuffer=True)` renders the G-buffer first and seeds
bounce 0 from it (dense only, as in the JAX package). `narrow` ("jobs",
the default, or "scan") picks the narrow phase of a multi-tile scene's
sweeps, as the JAX package's `tune.narrow` does; the image is the same bit
for bit.

A frame is the JAX package's compiled step: `render_step` (trace +
accumulate) and `present_step` (post-process + history swap), plain
functions on tensors with the JAX package's signatures (`narrow` in the
place of its `tune`). On the card `Renderer` runs them through
`CapturedSteps`, one CUDA graph for each key that a `jax.jit` retrace
would see (`step_key`: the static arguments, the shapes and dtypes of the
tensors, the scene's host ints), so a frame and a present are each one
graph replay; `build_pipeline(depth, spp)` and `update_screen_size` give a
new key, captured at the next frame, as they give JAX a recompile. A
reupload of equal shapes (an animated tick) and a loaded checkpoint are
copied into the graphs' tensors at the next frame and capture nothing. On
the CPU the steps run eagerly (`EagerSteps`).

The native world lives behind the async `WorldBridge` (`self.bridge`, and
`self.world` is its world): the recorder and the CLI tick the scene on the
bridge's thread while the device renders, and call `reupload_scene` only
after `bridge.wait()`. `set_animation`, `load_animation_glb` and
`update_screen_size` are the JAX package's calls; a resize reallocates the
accumulator and the TAA history on the renderer's device.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..config import RenderConfig
from ..models.bridge import WorldBridge
from ..ops import cuda_present
from ..ops.api import choose_backend, get_tracer
from ..ops.bvh_shade import pack_shade
from ..ops.cuda_dense import NARROW
from ..ops.fetch import device_pyramid
from ..ops.gbuffer import render_gbuffer
from ..ops.intersect import pack_walk
from ..ops.trace import accumulate, scene_packs
from ..utils.halton import JitterAccumulator
from ..utils.profiling import count, span
from ..utils.textures import build_quad_pyramid, decode_world_textures
from .resources import DeviceScene, build_device_scene, unpack_instances
from .worldtris import build_world_tables


def render_step(scene, camera, frame_count, jitter, accum, *, width: int,
                height: int, spp: int, max_depth: int, backend: str = "bvh",
                use_gbuffer: bool = False, narrow: str = "jobs"):
    """One progressive frame: trace + accumulate, the JAX package's
    `render_step`. `scene` is (WorldTables, textures) for "dense" and a
    DeviceScene for "bvh"; camera (24,) f32, frame_count (an int or a 0-d
    int64 tensor), jitter (2,) f32 and accum (W*H, 4) f32 on its device.
    `accum` is written and returned: the JAX package's donated argument.

    use_gbuffer=True (dense; ignored on "bvh", as in the JAX package)
    renders the primary-visibility G-buffer first and seeds every sample's
    bounce 0 from its id channel; at lens radius 0 the radiance is
    bit-identical to the traced path. `narrow` picks a multi-tile scene's
    narrow phase (the JAX package's `tune.narrow`).

    Returns (accum, rays): rays is the exact float64 device count of this
    frame's rays, the G-buffer's own W*H primary rays included."""
    kwargs = {"narrow": narrow} if backend == "dense" else {}
    gb_rays = 0.0
    if use_gbuffer and backend == "dense":
        tables, textures = scene
        gb = render_gbuffer(tables, textures, camera, width, height,
                            jitter=jitter, narrow=narrow)
        kwargs["seed_wt_idx"] = gb.wt_idx.reshape(-1)
        gb_rays = float(width * height)
    col, rays = get_tracer(backend)(scene, camera, frame_count, jitter,
                                    width, height, spp, max_depth,
                                    with_stats=True, **kwargs)
    return accumulate(accum, col, frame_count), rays + gb_rays


def present_step(accum, history, frame_count, average_jitter, *, width: int,
                 height: int, unjitter: bool = True):
    """Post-process + history swap, the JAX package's `present_step`:
    (ldr (H, W, 3) uint8, history). The new TAA history is written into
    `history` (H, W, 3) f32, which is returned. unjitter=False (a frame
    count past 16, known to the caller) skips the un-jitter resample that
    such a frame does not select: the same image, and on the card a second
    graph without the resample. On the card the chain is `csrc/present.cu`
    (two launches, `ops/cuda_present.py`), on the CPU the plain
    `postprocess`, the same bits."""
    return cuda_present.present(accum.view(height, width, 4), history,
                                frame_count, average_jitter, unjitter)


def _signature(x):
    """What a retrace sees of a step argument: a tensor's shape, dtype and
    device; a host value (a light count, a texture level's shape, a flag)
    itself."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.device
    if isinstance(x, tuple):
        return type(x).__name__, tuple(_signature(v) for v in x)
    return x


def step_key(step, args: tuple, static: dict) -> tuple:
    """The key a step is captured under: the step itself, its static
    arguments, and `_signature` of the others, as `jax.jit` keys its cache.
    The step counts by identity (a bound method by its function and
    object), not by name: the sharded steps' bodies share their names."""
    return step, tuple(sorted(static.items())), _signature(args)


def _tensors(x):
    """The tensors of a step argument, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)


class EagerSteps:
    """Runs a step as it is: the CPU's frame steps, and on the card the
    eager frame that the captured steps are held to."""

    def run(self, step, args: tuple, static: dict, donate: tuple = ()):
        """(step's outputs, args): the `CapturedSteps.run` interface."""
        with span("steps.run"):
            return step(*args, **static), args


# CUDA captures one graph at a time in a process: a lock across the
# renderers of one process (the farm's workers are threads).
_CAPTURE_LOCK = threading.Lock()


class _Captured(NamedTuple):
    """One captured step."""

    graph: object    # the CUDA graph
    args: tuple      # the arguments it reads: a replay reads them again
    out: tuple       # the outputs it writes
    packs: dict      # argument index -> the DeviceScene's packs it reads
    launches: dict   # kernel launches of one replay
    size: tuple      # (width, height) of its image


class CapturedSteps:
    """The frame steps as CUDA graphs on one card: one graph for each
    `step_key`, all in one memory pool.

    `run` captures a step at the first call of its key and replays it at
    every call, the first included (a capture runs nothing). Before a
    capture the kernel library and a DeviceScene's packs are built
    eagerly, and the step runs once on copies of the arguments it writes
    (`donate`), so every kernel is loaded before the capture records it; a
    capture that fails raises. A replay first copies into the graph's
    argument tensors every given tensor that is not one of them (a
    reuploaded scene of the same shapes, a new camera, an accumulator
    loaded from a checkpoint) and rebuilds a copied DeviceScene's packs
    into the graph's; `run` returns the graph's arguments, so the caller
    can hold those and the next call copies nothing. Outputs that are not
    arguments are returned as copies, which a later replay does not
    overwrite. Capturing a step of another image size (its static
    `width` and `height`) drops the entries of the old size; their memory
    goes back to the pool. A sharded step (`parallel/sharding.py`) has a
    CapturedSteps of its own and static arguments fixed when it is built,
    with no `height` among them: none of its entries is dropped, and they
    go with the step. The warm-up's eager call also opens a sharded step's
    NCCL communicators, which must exist before a capture records a
    collective.

    `kernels.launches` counts a graph's kernel launches at each replay and
    not at its capture. `captures` lists (key, capture ms) in order; the
    process-wide counters `captures` and `capture_ms` (`utils/profiling`)
    add up every instance's. A call's spans: `steps.key`, then
    `steps.capture` or `steps.feed`, `steps.replay` and `steps.outputs`
    (the copies of outputs that are not arguments)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = None
        self.entries: dict = {}
        self.captures: list = []

    def run(self, step, args: tuple, static: dict, donate: tuple = ()):
        with span("steps.key"):
            key = step_key(step, args, static)
            entry = self.entries.get(key)
        if entry is None:
            with span("steps.capture"):
                entry = self._capture(key, step, args, static, donate)
        else:
            with span("steps.feed"):
                self._feed(entry, args)
        with span("steps.replay"):
            entry.graph.replay()
            for k, v in entry.launches.items():
                kernels.launches[k] += v
        with span("steps.outputs"):
            mine = {id(t) for t in _tensors(entry.args)}
            return tuple(o if id(o) in mine else o.clone()
                         for o in entry.out), entry.args

    def _feed(self, entry, args):
        for i, (mine, given) in enumerate(zip(entry.args, args)):
            copied = False
            for m, g in zip(_tensors(mine), _tensors(given)):
                if g is not m:
                    m.copy_(g)
                    copied = True
            if copied and i in entry.packs:
                fresh = (pack_walk(mine), pack_shade(mine))
                for m, g in zip(_tensors(entry.packs[i]), _tensors(fresh)):
                    if g is not m:
                        m.copy_(g)

    def _capture(self, key, step, args, static, donate):
        size = (static.get("width"), static.get("height"))
        self.entries = {k: e for k, e in self.entries.items()
                        if e.size == size}
        kernels.library()
        packs = {i: scene_packs(a) for i, a in enumerate(args)
                 if isinstance(a, DeviceScene)}
        with _CAPTURE_LOCK:
            before = dict(kernels.launches)
            try:
                t0 = time.perf_counter()
                step(*(a.clone() if i in donate else a
                       for i, a in enumerate(args)), **static)
                warm = {k: v - before[k] for k, v in kernels.launches.items()}
                graph, out = self._record(step, args, static)
                ms = 1e3 * (time.perf_counter() - t0)
            finally:
                taken = {k: v - before[k] for k, v in kernels.launches.items()}
                for k, v in taken.items():
                    kernels.launches[k] -= v
        launches = {k: v - warm[k] for k, v in taken.items()}
        entry = _Captured(graph, args, out, packs, launches, size)
        self.entries[key] = entry
        self.captures.append((key, ms))
        count("captures")
        count("capture_ms", ms)
        return entry

    def _record(self, step, args, static):
        """Capture one call of `step` into a CUDA graph in the shared pool:
        (graph, outputs). Python's cyclic GC is held off during the
        capture: a dropped step that sits in a reference cycle (a
        `ShardedStep`) is freed only by the GC, and freeing its graph and
        pool inside a capture invalidates the capture."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = step(*args, **static)
        except BaseException:
            # A capture that CUDA refused leaves torch on the capture stream
            # and recording into the pool: undo both, then raise.
            torch.cuda.set_stream(stream)
            try:
                torch._C._cuda_endAllocateToPool(stream.device_index,
                                                 self.pool)
            except RuntimeError:  # torch had ended the recording
                pass
            self.pool = None
            raise
        finally:
            if gc_on:
                gc.enable()
        return graph, out

    def pool_bytes(self) -> int:
        """Bytes of device memory in the graphs' pool."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))


def world_tri_count(world) -> int:
    """Triangles of the flattened world: each instance counts its
    geometry's triangles (one bincount, one gather an instance)."""
    topo = np.asarray(world.topology()).reshape(-1, 20)
    geoms = unpack_instances(np.asarray(world.instances(), np.float32))[3]
    per_geom = np.bincount(topo[:, 3].astype(np.int64),
                           minlength=int(geoms.max(initial=-1)) + 1)
    return int(per_geom[geoms].sum())


class Renderer:
    """End-to-end progressive path tracer over a native World, on one
    device ("cuda" by default; raises when CUDA is absent). The positional
    arguments are the JAX package's: scene, OBJ text, GLB bytes, config.
    `backend` is "dense" or "bvh" (`ops/api.choose_backend`); the dense
    path keeps its `tables`, the BVH path its `scene`. Construction's span
    `scene.textures` covers the textures' decode, pyramid and upload, and
    a textured scene adds its layers and that host ms to the process-wide
    counters `texture_layers` and `texture_load_ms`."""

    def __init__(self, scene_name: str = "cornell",
                 obj_source: Optional[str] = None,
                 glb_data: Optional[bytes] = None,
                 config: Optional[RenderConfig] = None, *, device="cuda",
                 narrow: str = "jobs"):
        self.device = torch.device(device)
        if narrow not in NARROW:
            raise ValueError(f"narrow {narrow!r}: one of {sorted(NARROW)}")
        self.narrow = narrow
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): CUDA is not "
                               "available; pass device='cpu'")
        if config is None:
            config = RenderConfig(scene_name=scene_name)
        elif scene_name != "cornell":
            config.scene_name = scene_name
        self.config = config
        self.width = config.width
        self.height = config.height
        self.max_depth = config.max_depth
        self.spp = config.shader_spp

        # The scene compiler lives behind the async bridge, so a scene tick
        # can overlap device work; `world` is the bridge's own world.
        self.bridge = WorldBridge(config.scene_name, obj_source, glb_data)
        self.world = self.bridge.world
        if 0 < config.anim_index < self.world.animation_count():
            self.world.set_animation(config.anim_index)
            self.world.update(0.0)
        # Textures never change across scene ticks: decode and pack them
        # once and keep the device pyramid. None is the white placeholder.
        t0 = time.perf_counter()
        with span("scene.textures"):
            decoded = decode_world_textures(self.world)
            self.textures = (None if decoded is None else device_pyramid(
                build_quad_pyramid(decoded), self.device))
        if decoded is not None:
            count("texture_layers", decoded.shape[0])
            count("texture_load_ms", 1e3 * (time.perf_counter() - t0))
        self.backend = choose_backend(world_tri_count(self.world),
                                      self.device)
        self.tables = self.scene = None
        self.reupload_scene(reset=False)

        self.frame_count = 0
        self.last_rays = None
        self.launches = {k: 0 for k in kernels.launches}
        self._jitter_acc = JitterAccumulator(self.width, self.height)
        # The steps' per-frame inputs, written on the device before a step.
        self._frame = torch.zeros((), dtype=torch.int64, device=self.device)
        self._jitter = torch.zeros(2, dtype=torch.float32, device=self.device)
        self._avg_jitter = torch.zeros(2, dtype=torch.float32,
                                       device=self.device)
        self.steps = (CapturedSteps(self.device)
                      if self.device.type == "cuda" else EagerSteps())
        self._alloc_buffers()

    # -- lifecycle ---------------------------------------------------------

    def _alloc_buffers(self):
        self.accum = torch.zeros((self.width * self.height, 4),
                                 dtype=torch.float32, device=self.device)
        self.history = torch.zeros((self.height, self.width, 3),
                                   dtype=torch.float32, device=self.device)

    def build_pipeline(self, max_depth: int, spp: int):
        """Change depth / spp; resets accumulation."""
        self.max_depth = int(max_depth)
        self.spp = int(spp)
        self.reset_accumulation()

    def update_screen_size(self, width: int, height: int):
        """Resize: a new camera, jitter sequence and accumulation."""
        self.width = int(width)
        self.height = int(height)
        self.world.update_camera(self.width, self.height)
        self.camera = torch.from_numpy(
            np.asarray(self.world.camera(), np.float32)).to(self.device)
        self.reset_accumulation()

    def reset_accumulation(self):
        """The accumulator reset is semantic (frame 1 overwrites), as in the
        JAX package; the TAA history feeds frame 1 and is cleared. After a
        resize both buffers are reallocated at the new size."""
        self.frame_count = 0
        self._jitter_acc = JitterAccumulator(self.width, self.height)
        if self.accum.shape != (self.width * self.height, 4):
            self._alloc_buffers()
        else:
            self.history.zero_()

    # -- scene updates -----------------------------------------------------

    def update_scene(self, time: float, reset: bool = True):
        """Tick the native scene compiler and re-upload the tables."""
        self.world.update(time)
        self.reupload_scene(reset=reset)

    def set_animation(self, index: int, time: float = 0.0):
        """Select the active animation clip and re-flatten the scene at
        `time`; resets the accumulation."""
        self.world.set_animation(int(index))
        self.config.anim_index = int(index)
        self.update_scene(time)

    def load_animation_glb(self, data: bytes) -> bool:
        """Merge animation clips from another GLB; True if it had any."""
        return self.world.load_animation_glb(data)

    def reupload_scene(self, reset: bool = True):
        """Rebuild and upload the backend's scene from the (already
        updated) world: the world tables for "dense", the DeviceScene for
        "bvh". The upload half of `update_scene`. With the bridge, call it
        after `bridge.wait()` and before the next `update_async`, which
        rewrites the world's buffers. Spans: `reupload_scene`, with
        `upload.tables` and `upload.camera`."""
        with span("reupload_scene"):
            with span("upload.tables"):
                if self.backend == "dense":
                    self.tables = build_world_tables(self.world, self.device)
                else:
                    self.scene = build_device_scene(
                        self.world, textures=None if self.textures is None
                        else self.textures[0], device=self.device)
            with span("upload.camera"):
                self.world.update_camera(self.width, self.height)
                self.camera = torch.from_numpy(
                    np.asarray(self.world.camera(), np.float32)).to(
                        self.device)
            if reset:
                self.reset_accumulation()

    # -- per-frame ---------------------------------------------------------

    def _render_args(self) -> tuple:
        scene = ((self.tables, self.textures) if self.backend == "dense"
                 else self.scene)
        return scene, self.camera, self._frame, self._jitter, self.accum

    def _render_static(self, use_gbuffer: bool) -> dict:
        return dict(width=self.width, height=self.height, spp=self.spp,
                    max_depth=self.max_depth, backend=self.backend,
                    use_gbuffer=use_gbuffer and self.backend == "dense",
                    narrow=self.narrow)

    def render_key(self, use_gbuffer: bool = False) -> tuple:
        """The key the next `render_frame(use_gbuffer)` runs its step
        under (`step_key`)."""
        return step_key(render_step, self._render_args(),
                        self._render_static(use_gbuffer))

    def render_frame(self, use_gbuffer: bool = False):
        """Trace one progressive frame into the accumulator: one
        `render_step` (one graph replay on the card).

        use_gbuffer=True (dense backend; ignored on "bvh", as in the JAX
        package) renders the primary-visibility G-buffer first and seeds
        every sample's bounce 0 from its id channel instead of tracing
        primaries; at lens radius 0 the radiance is bit-identical.

        Sets self.last_rays (float64 device scalar, unread until needed) to
        the exact ray count of this frame, the G-buffer's own W*H primary
        rays included, and adds this frame's kernel launches to
        self.launches.

        Spans: `render_frame` (its frame id the new frame count), with
        `render_frame.inputs` (the jitter step and the five device fills)
        and the steps' own."""
        self.frame_count += 1
        with span("render_frame", self.frame_count):
            with span("render_frame.inputs"):
                jitter, avg = self._jitter_acc.step(self.frame_count)
                self._frame.fill_(self.frame_count)
                for buf, v in ((self._jitter, jitter),
                               (self._avg_jitter, avg)):
                    buf[0].fill_(float(v[0]))
                    buf[1].fill_(float(v[1]))
            before = dict(kernels.launches)
            (self.accum, self.last_rays), args = self.steps.run(
                render_step, self._render_args(),
                self._render_static(use_gbuffer), donate=(4,))
            scene, self.camera = args[:2]
            if self.backend == "dense":
                self.tables, self.textures = scene
            else:
                self.scene = scene
            for k, v in kernels.launches.items():
                self.launches[k] += v - before[k]
        return self.accum

    def present(self) -> np.ndarray:
        """Run the post-process chain (one `present_step`, one graph replay
        on the card); returns (H, W, 3) uint8. Call once per rendered
        frame: the TAA history blend uses alpha = 1/frame. Adds the
        present's kernel launches to self.launches.

        Spans: `present`, with `present.inputs` (the frame count's fill),
        the steps' own and `present.copy`, the image's copy to the host,
        which waits for the device."""
        with span("present", self.frame_count):
            with span("present.inputs"):
                self._frame.fill_(self.frame_count)
            before = kernels.launches["present"]
            (ldr, self.history), args = self.steps.run(
                present_step, (self.accum, self.history, self._frame,
                               self._avg_jitter),
                dict(width=self.width, height=self.height,
                     unjitter=self.frame_count <= 16), donate=(1,))
            self.accum = args[0]
            self.launches["present"] += kernels.launches["present"] - before
            with span("present.copy"):
                self._last_frame = ldr.cpu().numpy()
        return self._last_frame

    def capture_frame(self) -> np.ndarray:
        """The last presented LDR image; presents first when no frame was
        presented yet."""
        if not hasattr(self, "_last_frame"):
            return self.present()
        return self._last_frame

    def radiance(self) -> np.ndarray:
        """Mean HDR radiance of the accumulator, (H, W, 3) float32."""
        acc = self.accum.cpu().numpy().reshape(self.height, self.width, 4)
        return acc[..., 0:3] / np.maximum(acc[..., 3:4], 1e-20)
