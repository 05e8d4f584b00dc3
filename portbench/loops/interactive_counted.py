"""The interactive loop (`loops/interactive.py`, the same traffic keys),
for a program that has a launch counter for every kernel the benchmark
names (`kernels/<counter>.json`).

A traced run holds the profiler's count of each named kernel to the
program's counter of it; a program without the counter reads 0 there, so
a window whose frames launch that kernel can never pass the check. This
loop refuses such a program at once, before it builds anything, naming
the counters it lacks, rather than after a whole window.
"""

from __future__ import annotations

import os

from portbench.lib import drivers, spec

INTERACTIVE = spec.load_module(os.path.join(spec.HERE, "loops",
                                            "interactive.py"))


def run(cfg, traffic, seed, seconds, trace, device, phases, patterns):
    missing = sorted(set(patterns) - set(drivers.program()[2].launches))
    if missing:
        raise RuntimeError(f"the program has no launch counter for "
                           f"{missing}: a traced run could not hold the "
                           f"profiler's count of those kernels to it")
    return INTERACTIVE.run(cfg, traffic, seed, seconds, trace, device,
                           phases, patterns)
