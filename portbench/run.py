"""Run one cell of the benchmark once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. `BENCHMARK.json` names the cell's
configuration, traffic mix and metrics; each is a file under `portbench/`
(`lib/spec.py`). The run sets up the program (build or load of the kernels,
scene, captures of every step key the window uses), measures for
`--seconds`, then checks what the window produced against the plain
reference. The last line of standard output is one JSON object: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics from one profiled stretch of the window. The numbers the check
compared, each beside its limit, come last in that line and as the last
lines of standard error.

Exits non-zero, with no result, without CUDA or with fewer cards than the
cell asks for, and if `jax`, `jaxlib`, `flax` or the JAX package
(`webgpu_raytracer_tpu`) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import check, drivers, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "webgpu_raytracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(bench: spec.Spec, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float = T_START,
             overrides: dict | None = None,
             phases: drivers.Phases | None = None) -> dict:
    """One run of a cell: the result object (without `device`). `overrides`
    replace configuration or traffic keys (the harness's own tests run a
    cell at a tiny size on the CPU with them)."""
    cell = bench.workload(workload)
    cfg = dict(bench.config(cell["config"]), **(overrides or {}))
    traffic = dict(bench.traffic(cell["traffic"]), **(overrides or {}))
    limits = bench.limits(workload)
    loop = bench.loop(cell["traffic"])
    window = loop.run(cfg, traffic, seed, seconds, trace, device,
                      phases or drivers.Phases(t_start),
                      spec.kernel_patterns())
    numbers, facts = check.check(window, cfg, device)
    window.tris, window.light_rows = facts["tris"], facts["light_rows"]

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(kind, workload):
        reader = bench.reader(kind, m["name"])
        value = (reader.read(window.trace, window) if trace
                 else reader.read(window))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    out = {"correct": all(v <= limits[k] for k, v in numbers.items()),
           "attempted": window.frames, "failed": 0, "metrics": metrics,
           "memory_peak_bytes": window.memory_peak_bytes}
    if trace:
        out["busy_s"] = window.trace.busy_s()
        out["window_s"] = window.trace.window_s
        out["breakdown"] = window.trace.breakdown()
        out["trace_log"] = {"launches": window.trace.launches,
                            "frames": window.trace.frames,
                            "presents": window.trace.presents,
                            "profiles": window.trace.log}
    out["checked"] = facts["checked"]
    out["setup_phases_s"] = window.phases
    out["checks"] = checks
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.Spec()
    chips = bench.workload(args.workload)["chips"]
    phases = drivers.Phases(T_START)
    import torch
    phases.mark("python, torch import")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    phases.mark("CUDA start")
    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), phases=phases)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = res.pop("busy_s")
        device["window_s"] = res.pop("window_s")
    checks = res.pop("checks")
    line = {"correct": res.pop("correct"), "attempted": res.pop("attempted"),
            "failed": res.pop("failed"), "metrics": res.pop("metrics"),
            "device": device, **res, "card": power_limit(),
            "checks": checks}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
