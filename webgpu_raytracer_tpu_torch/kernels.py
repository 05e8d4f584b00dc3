"""Build and load the port's CUDA kernels; count their launches.

The sources in `csrc/*.cu` have a plain C interface. At first CUDA use,
`library()` compiles them with nvcc, one process per source, all started
together, and links the objects into one shared library under `build/`
(listed in `.gitignore`), named by a hash of the sources, the shared
`csrc/*.cuh` headers and the flags, so an edited source or header
rebuilds and an unchanged one is loaded as it is. The library
is loaded with ctypes: every pointer and the stream go as `c_void_p`, and
every C entry point returns `cudaGetLastError()` after its launch.

Nothing here runs at import: the CPU tests import every module, on hosts
that may have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# Flags of one source only. bvh_shade.cu and present.cu round every product
# and sum on their own, as their plain versions' tensor operations do: no
# FMA contraction.
SOURCE_FLAGS = {"bvh_shade.cu": ("--fmad=false",),
                "present.cu": ("--fmad=false",)}

# Launch counts by kernel. A wrapper adds one where it launches its kernel
# and nowhere else, so a run can show that its path went through it;
# "bvh_walk" counts both of bvh_walk.cu's walks (closest and any-hit, each
# also under its own name), "all_reduce" the sharded steps' collectives
# (one NCCL kernel each), "present" both of present.cu's passes (two a
# present).
launches = {"dense_sweep": 0, "shade_rows": 0, "fetch_rows": 0,
            "fetch_quad": 0, "cluster_cull": 0, "job_sweep": 0,
            "cluster_cull_keyed": 0, "scan_sweep": 0, "bvh_closest": 0,
            "bvh_shadow": 0, "bvh_walk": 0, "bvh_shade": 0, "all_reduce": 0,
            "present": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _source_flags(src: str) -> tuple[str, ...]:
    return SOURCE_FLAGS.get(os.path.basename(src), ())


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        h.update(" ".join(_source_flags(src)).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwrt_kernels_{h.hexdigest()[:16]}.so")


def build(extra_flags: tuple[str, ...] = ()) -> tuple[str, float, str]:
    """Compile csrc/*.cu unless the library for these sources exists.

    Returns (library path, build seconds, nvcc's output); 0 s when it was
    already built."""
    path = _library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{path[:-3]}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = f"{stem}.{os.path.basename(src)}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *_source_flags(src), *extra_flags, "-c",
             "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = [proc.communicate()[0] for _, proc in jobs]  # wait for all
    for (_, proc), out in zip(jobs, log):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
    tmp = f"{stem}.tmp.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                           *(obj for obj, _ in jobs)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    for obj, _ in jobs:
        os.remove(obj)
    return path, seconds, "".join(log) + proc.stdout + proc.stderr


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build()[0])
    lib.wrt_dense_sweep.restype = _I
    lib.wrt_dense_sweep.argtypes = [_P, _I, _I, _P, _P, _I, _F, _I, _I,
                                    _P, _P, _P, _P, _P]
    lib.wrt_shade_rows.restype = _I
    lib.wrt_shade_rows.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _P, _P, _P, _P]
    lib.wrt_shade_rows_textured.restype = _I
    lib.wrt_shade_rows_textured.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _P, _I, _I, _I, _P, _I, _I,
                                            _I, _P, _P, _P, _P]
    lib.wrt_fetch_rows_t.restype = _I
    lib.wrt_fetch_rows_t.argtypes = [_P, _I, _I, _P, _I, _P, _P]
    lib.wrt_fetch_quad.restype = _I
    lib.wrt_fetch_quad.argtypes = [_P, _I, _P, _I, _P, _P]
    lib.wrt_cluster_cull.restype = _I
    lib.wrt_cluster_cull.argtypes = [_P, _I, _P, _I, _I, _P, _F, _F, _P, _P,
                                     _P]
    lib.wrt_job_sweep.restype = _I
    lib.wrt_job_sweep.argtypes = [_P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _P,
                                  _P, _I, _F, _F, _F, _I, _I, _P, _P, _P, _P,
                                  _P, _I, _P, _P]
    lib.wrt_job_sweep_scratch_bytes.restype = ctypes.c_size_t
    lib.wrt_job_sweep_scratch_bytes.argtypes = [_I, _I, _I, _I]
    lib.wrt_cluster_cull_keyed.restype = _I
    lib.wrt_cluster_cull_keyed.argtypes = [_P, _I, _P, _I, _I, _P, _F, _P,
                                           _P]
    lib.wrt_scan_sweep.restype = _I
    lib.wrt_scan_sweep.argtypes = [_P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _P,
                                   _P, _P, _I, _F, _F, _F, _I, _I, _P, _P, _P,
                                   _P, _P, _P]
    lib.wrt_bvh_walk.restype = _I
    lib.wrt_bvh_walk.argtypes = [_P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P,
                                 _F, _F, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _P]
    lib.wrt_bvh_shade.restype = _I
    lib.wrt_bvh_shade.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P]
    lib.wrt_present.restype = _I
    lib.wrt_present.argtypes = [_P, _I, _I, _P, _P, _P, _I, _F, _F, _F, _F,
                                _F, _F, _P, _P, _P]
    return lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None, device: torch.device | None = None):
    """Raise unless `t` is a contiguous CUDA tensor of this dtype/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {code}")
