"""What a run loads and where it can run: no JAX and no JAX package in a
run's process, nothing of the system under test in the reference, no
result without a card or outside a checkout."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench.lib import spec
from portbench.run import FORBIDDEN, forbidden_modules

ROOT = spec.ROOT


def _python(code: str, cwd: str = ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "webgpu_raytracer_tpu_torch.fake",
                        object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "webgpu_raytracer_tpu.ops", object())
    assert forbidden_modules() == ["jax", "webgpu_raytracer_tpu"]


def test_a_run_loads_no_jax():
    """A whole cell run, in a process of its own, then its modules."""
    out = _python("""
        import time, json
        from portbench.lib import spec
        from portbench.run import run_cell, forbidden_modules
        res = run_cell(spec.Spec(), "cornell-interactive", 7, 0.3, False,
                       device="cpu", t_start=time.perf_counter(),
                       overrides=dict(width=16, height=12, max_depth=2,
                                      check_within=1, check_frames=1))
        import sys
        print(json.dumps([res["correct"], forbidden_modules(),
                          "webgpu_raytracer_tpu_torch" in sys.modules]))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, [], true]"


def test_reference_loads_nothing_of_the_program():
    out = _python("""
        import json, sys
        import portbench.reference.pathtrace, portbench.reference.post
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "webgpu_raytracer_tpu",
                         "webgpu_raytracer_tpu_torch"}


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cornell-interactive", "--seed", "5", "--seconds", "1"],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_outside_a_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in spec.Spec().data["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cornell-interactive", "--seed", "5", "--seconds", "1"],
        cwd=tmp_path, env={k: v for k, v in os.environ.items()
                           if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short traced run of cornell-interactive on the card: correct,
    every listed metric read, shares within 100%, and the profile's
    kernel counts equal to the program's launch counters."""
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cornell-interactive", "--seed", "8675309", "--seconds", "3",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    want = {m["name"] for m in spec.Spec().metrics("per_layer",
                                                   "cornell-interactive")}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, name
    assert line["device"]["busy_s"] > 0
