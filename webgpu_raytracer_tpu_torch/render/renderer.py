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
PyTorch runs eagerly, so there is no compiled step:
`build_pipeline(depth, spp)` only changes the parameters and resets the
accumulation.

The native world lives behind the async `WorldBridge` (`self.bridge`, and
`self.world` is its world): the recorder and the CLI tick the scene on the
bridge's thread while the device renders, and call `reupload_scene` only
after `bridge.wait()`. `set_animation`, `load_animation_glb` and
`update_screen_size` are the JAX package's calls; a resize reallocates the
accumulator and the TAA history on the renderer's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..config import RenderConfig
from ..models.bridge import WorldBridge
from ..ops.api import choose_backend
from ..ops.cuda_dense import NARROW
from ..ops.dense_trace import trace_pixels_dense
from ..ops.fetch import device_pyramid
from ..ops.gbuffer import render_gbuffer
from ..ops.postprocess import postprocess
from ..ops.trace import accumulate, trace_pixels
from ..utils.halton import JitterAccumulator
from ..utils.textures import build_quad_pyramid, decode_world_textures
from .resources import build_device_scene, unpack_instances
from .worldtris import build_world_tables


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
    path keeps its `tables`, the BVH path its `scene`."""

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
        decoded = decode_world_textures(self.world)
        self.textures = (None if decoded is None else device_pyramid(
            build_quad_pyramid(decoded), self.device))
        self.backend = choose_backend(world_tri_count(self.world),
                                      self.device)
        self.tables = self.scene = None
        self.reupload_scene(reset=False)

        self.frame_count = 0
        self.last_rays = None
        self.launches = {k: 0 for k in kernels.launches}
        self._jitter_acc = JitterAccumulator(self.width, self.height)
        self._avg_jitter = torch.zeros(2, dtype=torch.float32,
                                       device=self.device)
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
        rewrites the world's buffers."""
        self.world.update_camera(self.width, self.height)
        if self.backend == "dense":
            self.tables = build_world_tables(self.world, self.device)
        else:
            self.scene = build_device_scene(
                self.world, textures=None if self.textures is None
                else self.textures[0], device=self.device)
        self.camera = torch.from_numpy(
            np.asarray(self.world.camera(), np.float32)).to(self.device)
        if reset:
            self.reset_accumulation()

    # -- per-frame ---------------------------------------------------------

    def render_frame(self, use_gbuffer: bool = False):
        """Trace one progressive frame into the accumulator.

        use_gbuffer=True (dense backend; ignored on "bvh", as in the JAX
        package) renders the primary-visibility G-buffer first and seeds
        every sample's bounce 0 from its id channel instead of tracing
        primaries; at lens radius 0 the radiance is bit-identical.

        Sets self.last_rays (float64 device scalar, unread until needed) to
        the exact ray count of this frame, the G-buffer's own W*H primary
        rays included, and adds this frame's kernel launches to
        self.launches."""
        self.frame_count += 1
        jitter, avg = self._jitter_acc.step(self.frame_count)
        self._avg_jitter = torch.from_numpy(avg).to(self.device)
        jitter = torch.from_numpy(jitter).to(self.device)
        before = dict(kernels.launches)
        seed, gb_rays = None, 0.0
        if self.backend == "bvh":
            col, rays = trace_pixels(
                self.scene, self.camera, self.frame_count, jitter,
                self.width, self.height, self.spp, self.max_depth,
                with_stats=True)
        else:
            if use_gbuffer:
                gb = render_gbuffer(self.tables, self.textures, self.camera,
                                    self.width, self.height, jitter=jitter,
                                    narrow=self.narrow)
                seed = gb.wt_idx.reshape(-1)
                gb_rays = float(self.width * self.height)
            col, rays = trace_pixels_dense(
                self.tables, self.camera, self.frame_count, jitter,
                self.width, self.height, self.spp, self.max_depth,
                with_stats=True, textures=self.textures, seed_wt_idx=seed,
                narrow=self.narrow)
        self.last_rays = rays + gb_rays
        self.accum = accumulate(self.accum, col, self.frame_count)
        for k, v in kernels.launches.items():
            self.launches[k] += v - before[k]
        return self.accum

    def present(self) -> np.ndarray:
        """Run the post-process chain; returns (H, W, 3) uint8. Call once
        per rendered frame: the TAA history blend uses alpha = 1/frame."""
        ldr, self.history = postprocess(
            self.accum.view(self.height, self.width, 4), self.history,
            self.frame_count, self._avg_jitter)
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
