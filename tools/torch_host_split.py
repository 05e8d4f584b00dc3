#!/usr/bin/env python3
"""Where a benchmark cell's device-idle time goes, by the program's spans.

Run from a checkout's root on a machine with one NVIDIA GPU:

    python3 tools/torch_host_split.py split --workload cornell-record \\
        --seed 7 --seconds 10 [--out host_split.jsonl]
    python3 tools/torch_host_split.py cost --workload cornell-interactive \\
        --seeds 1,2,3 --seconds 20

`split` runs one traced window of the cell (`portbench/`'s loop, stretch
and check) and prints one JSON line: the cell's per-layer metrics, the
alignment of the program's spans onto the profile (`lib/program.py`: the
offset's spread, first to third quartile and 5th to 95th percentile, and
the number of pairs), the stretch's device-idle ms a presented frame by
the innermost program span open on the main thread ("" outside every
span), the share of the idle inside program spans, and `present_ms`
computed again from the program's `present` spans beside the harness's.

`cost` runs untraced windows of the cell in turns, tracing off and spans
recording under `utils.profiling.tracing()` (no profiler), one seed each
way, and prints `frame_ms` and the rate of each run, then one JSON line;
a run with spans on also gives each span name's host ms a presented frame
on the main thread (whole spans, children included), without the
profiler's own cost.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

from portbench.lib import check, drivers, program, spec  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def present_ms_from_program(trace, prog) -> float:
    """Device ms a present of the operations launched inside the
    program's `present` spans."""
    spans = sorted((s, e) for n, s, e in prog.spans if n == "present")
    starts = [s for s, _ in spans]
    total = 0.0
    for o in trace.ops:
        if o.launch is None:
            continue
        i = bisect.bisect_right(starts, o.launch) - 1
        if i >= 0 and spans[i][1] >= o.launch:
            total += o.end - o.start
    return 1e3 * total / trace.presents


def split(args) -> dict:
    bench = spec.Spec()
    cell = bench.workload(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    window = bench.loop(cell["traffic"]).run(
        cfg, traffic, args.seed, args.seconds, True, args.device,
        drivers.Phases(time.perf_counter()), spec.kernel_patterns())
    numbers, facts = check.check(window, cfg, args.device)
    window.tris, window.light_rows = facts["tris"], facts["light_rows"]
    trace = window.trace
    metrics = {m["name"]: bench.reader("per_layer", m["name"]).read(
        trace, window) for m in bench.metrics("per_layer", args.workload)}
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "frames": trace.frames, "presents": trace.presents,
           "window_s": trace.window_s, "busy_s": trace.busy_s(),
           "metrics": metrics, "checks": numbers, "log": trace.log}
    prog = program.align(trace)
    if prog is None:
        out["aligned"] = False
        return out
    rel = sorted(prog.offsets_ns)
    q = statistics.quantiles(rel, n=20)
    split_s = prog.idle_by_span(trace)
    idle = sum(split_s.values())
    out.update(
        aligned=True, pairs=len(rel),
        offset_spread_us={"q1_q3": 1e6 * prog.spread_s,
                          "p5_p95": 1e-3 * (q[18] - q[0]),
                          "max_min": 1e-3 * (rel[-1] - rel[0])},
        idle_ms_per_present={k or "(outside program spans)":
                             1e3 * v / trace.presents
                             for k, v in sorted(split_s.items(),
                                                key=lambda kv: -kv[1])},
        idle_inside_share=(idle - split_s[""]) / idle if idle else None,
        present_ms_program=present_ms_from_program(trace, prog))
    return out


def host_ms(since: int, presents: int) -> dict:
    """Host ms a present of each span name recorded on the main thread
    after the span id `since`."""
    import threading

    from webgpu_raytracer_tpu_torch.utils.profiling import spans
    main = threading.main_thread().native_id
    out: dict = {}
    for s in spans():
        if s.id > since and s.thread == main:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns)
    return {k: 1e-6 * v / presents
            for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def cost(args) -> dict:
    from webgpu_raytracer_tpu_torch.utils.profiling import span, tracing
    bench = spec.Spec()
    runs = []
    seeds = [int(s) for s in args.seeds.split(",")]
    for k, seed in enumerate(seeds):
        order = ("off", "on") if k % 2 == 0 else ("on", "off")
        for mode in order:
            t = time.perf_counter()
            if mode == "on":
                with tracing():
                    with span("mark") as mark:
                        pass
                    res = run_cell(bench, args.workload, seed, args.seconds,
                                   False, t_start=t)
            else:
                res = run_cell(bench, args.workload, seed, args.seconds,
                               False, t_start=t)
            row = {"mode": mode, "seed": seed, "correct": res["correct"],
                   **{n: m["value"] for n, m in res["metrics"].items()}}
            if mode == "on":
                # Set-up's frames and the check's are in too: a share of
                # a percent in a window of thousands of frames.
                row["host_ms_per_present"] = host_ms(mark.id,
                                                     res["attempted"])
            print(json.dumps(row), flush=True)
            runs.append(row)
    key = "frame_ms" if "frame_ms" in runs[0] else None
    out = {"workload": args.workload, "card": card(), "runs": runs}
    if key:
        for mode in ("off", "on"):
            out[f"{key}_{mode}"] = statistics.median(
                r[key] for r in runs if r["mode"] == mode)
        out["on_cost_pct"] = 100.0 * (out[f"{key}_on"] / out[f"{key}_off"]
                                      - 1.0)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("split", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the tool (at the cell's size)")
    args = ap.parse_args(argv)
    out = split(args) if args.mode == "split" else cost(args)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
