"""ctypes bridge to the shared native scene compiler (`native/*.cpp`).

The port's copy of the JAX package's `models/native.py`, with the same
structure and names. The C++ scene compiler (model parsing, animation,
skinning, BLAS/TLAS builds, flat-buffer emission) is shared by both
packages as source; each builds its own library. At first use
`load_library()` compiles `native/*.cpp` with one g++ call into
`webgpu_raytracer_tpu_torch/build/libscene_<hash>.so` (listed in
`.gitignore`), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is loaded as it is. A file lock makes
concurrent first uses (test workers) build once.

Buffers are copied out of native memory into numpy arrays.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp")))


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(NATIVE_DIR,
                                                          "*.h"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libscene_{h.hexdigest()[:16]}.so")


def _build_library(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libscene.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return
        tmp = f"{path[:-3]}.{os.getpid()}.tmp.so"
        cxx = os.environ.get("CXX") or "g++"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_sources()],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the scene compiler failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) the native scene compiler."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        _build_library(path)
    lib = ctypes.CDLL(path)

    lib.wrt_world_create.restype = ctypes.c_void_p
    lib.wrt_world_create.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]
    lib.wrt_world_destroy.argtypes = [ctypes.c_void_p]
    lib.wrt_world_update.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.wrt_world_update_camera.argtypes = [
        ctypes.c_void_p,
        ctypes.c_float,
        ctypes.c_float,
    ]
    lib.wrt_world_animation_count.restype = ctypes.c_size_t
    lib.wrt_world_animation_count.argtypes = [ctypes.c_void_p]
    lib.wrt_world_animation_name.restype = ctypes.c_char_p
    lib.wrt_world_animation_name.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.wrt_world_set_animation.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.wrt_world_load_animation_glb.restype = ctypes.c_int
    lib.wrt_world_load_animation_glb.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]

    for name in (
        "tlas",
        "blas",
        "instances",
        "vertices",
        "normals",
        "uvs",
        "camera",
    ):
        fn = getattr(lib, f"wrt_world_{name}")
        fn.restype = ctypes.POINTER(ctypes.c_float)
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    for name in ("topology", "lights", "draw_commands"):
        fn = getattr(lib, f"wrt_world_{name}")
        fn.restype = ctypes.POINTER(ctypes.c_uint32)
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]

    lib.wrt_world_texture_count.restype = ctypes.c_size_t
    lib.wrt_world_texture_count.argtypes = [ctypes.c_void_p]
    lib.wrt_world_texture.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.wrt_world_texture.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]

    _lib = lib
    return lib


class NativeWorld:
    """Thin RAII wrapper over the C `World` handle."""

    def __init__(
        self,
        scene_name: str = "cornell",
        obj_source: Optional[str] = None,
        glb_data: Optional[bytes] = None,
    ):
        self._lib = load_library()
        glb_ptr = None
        glb_len = 0
        if glb_data:
            glb_buf = (ctypes.c_uint8 * len(glb_data)).from_buffer_copy(glb_data)
            glb_ptr = ctypes.cast(glb_buf, ctypes.POINTER(ctypes.c_uint8))
            glb_len = len(glb_data)
        self._handle = self._lib.wrt_world_create(
            scene_name.encode(),
            obj_source.encode() if obj_source is not None else None,
            glb_ptr,
            glb_len,
        )
        if not self._handle:
            raise RuntimeError(f"failed to create native world for {scene_name!r}")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wrt_world_destroy(handle)
            self._handle = None

    def update(self, time: float) -> None:
        self._lib.wrt_world_update(self._handle, float(time))

    def update_camera(self, width: float, height: float) -> None:
        self._lib.wrt_world_update_camera(self._handle, float(width), float(height))

    def _read(self, name: str, dtype) -> np.ndarray:
        length = ctypes.c_size_t(0)
        ptr = getattr(self._lib, f"wrt_world_{name}")(self._handle, ctypes.byref(length))
        if length.value == 0 or not ptr:
            return np.empty((0,), dtype=dtype)
        return np.ctypeslib.as_array(ptr, shape=(length.value,)).astype(dtype, copy=True)

    # Flat buffer accessors (layouts: SURVEY.md §2.2)
    def tlas(self) -> np.ndarray:
        return self._read("tlas", np.float32)

    def blas(self) -> np.ndarray:
        return self._read("blas", np.float32)

    def instances(self) -> np.ndarray:
        return self._read("instances", np.float32)

    def vertices(self) -> np.ndarray:
        return self._read("vertices", np.float32)

    def normals(self) -> np.ndarray:
        return self._read("normals", np.float32)

    def uvs(self) -> np.ndarray:
        return self._read("uvs", np.float32)

    def camera(self) -> np.ndarray:
        return self._read("camera", np.float32)

    def topology(self) -> np.ndarray:
        return self._read("topology", np.uint32)

    def lights(self) -> np.ndarray:
        return self._read("lights", np.uint32)

    def draw_commands(self) -> np.ndarray:
        return self._read("draw_commands", np.uint32)

    # Animation control
    def animation_count(self) -> int:
        return int(self._lib.wrt_world_animation_count(self._handle))

    def animation_name(self, index: int) -> str:
        return self._lib.wrt_world_animation_name(self._handle, index).decode()

    def set_animation(self, index: int) -> None:
        self._lib.wrt_world_set_animation(self._handle, index)

    def load_animation_glb(self, data: bytes) -> bool:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        ptr = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
        return bool(
            self._lib.wrt_world_load_animation_glb(self._handle, ptr, len(data))
        )

    # Textures (raw encoded bytes, decoded Python-side)
    def texture_count(self) -> int:
        return int(self._lib.wrt_world_texture_count(self._handle))

    def texture(self, index: int) -> bytes:
        length = ctypes.c_size_t(0)
        ptr = self._lib.wrt_world_texture(self._handle, index, ctypes.byref(length))
        if length.value == 0 or not ptr:
            return b""
        return ctypes.string_at(ptr, length.value)
