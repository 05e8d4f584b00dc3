"""% of its roofline that the textured shade kernel reaches over the
profiled stretch: the least time of its frames' work
(`roofline/shade_rows_tex.py`) over the profiler's device time of the
textured instantiation alone (`kernels/shade_rows_tex.json`). None where
the stretch launched none."""

from portbench.lib.spec import kernel_patterns, roofline


def read(trace, window):
    t = trace.device_s(kernel_patterns()["shade_rows_tex"])
    if t <= 0 or not trace.launches.get("shade_rows_tex"):
        return None
    return 100.0 * roofline("shade_rows_tex").least_s(trace, window) / t
