"""Host modules shared with the JAX package, loaded by file path.

`import webgpu_raytracer_tpu.<x>` runs that package's `__init__`, which
imports the JAX renderer. The three host modules the port needs are free of
JAX, so they are loaded straight from their files: one source of truth, no
copies, and no JAX in the process.

- `models/native.py`: the ctypes binding to the shared C++ scene compiler
  (`native/` -> `webgpu_raytracer_tpu/lib/libscene.so`, built by `make -C
  native` on first use);
- `config.py`: `RenderConfig`;
- `utils/halton.py`: the Halton(2,3) jitter sequence.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_REF_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "webgpu_raytracer_tpu")


def _load(rel_path: str, name: str):
    full = f"{__package__}._ref_{name}"
    mod = sys.modules.get(full)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        full, os.path.join(_REF_DIR, rel_path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod  # dataclasses resolve their module while built
    spec.loader.exec_module(mod)
    return mod


native = _load("models/native.py", "native")
config = _load("config.py", "config")
halton = _load("utils/halton.py", "halton")

NativeWorld = native.NativeWorld
RenderConfig = config.RenderConfig
JitterAccumulator = halton.JitterAccumulator
