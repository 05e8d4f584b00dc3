"""The readings that the output check's limits are set from, on the card.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--out chiprun_out/control.jsonl]

For each seed, one short window of the cell at its own size; then the
numbers the check compares, twice: for what the program produced (the
lower readings) and for the control, the plain reference computed in
bfloat16 put in the program's place (the upper readings). One JSON line a
seed. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import check, drivers, spec  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.Spec()
    cell = bench.workload(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    loop = bench.loop(cell["traffic"])
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            window = loop.run(cfg, traffic, seed, args.seconds, False,
                              "cuda", drivers.Phases(t0),
                              spec.kernel_patterns())
            t1 = time.perf_counter()
            program, facts = check.check(window, cfg, "cuda")
            t2 = time.perf_counter()
            control, _ = check.check(window, cfg, "cuda", control=True)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "program": program, "control": control,
                               "facts": facts,
                               "frames": window.frames,
                               "run_s": t1 - t0, "check_s": t2 - t1})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
