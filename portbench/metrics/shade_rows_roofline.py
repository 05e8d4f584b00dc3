"""% of its roofline that the shade kernel reaches over the profiled
stretch: the least time of its frames' work (`roofline/shade_rows.py`)
over the profiler's device time of its kernels."""

from portbench.lib.spec import kernel_patterns, roofline


def read(trace, window):
    t = trace.device_s(kernel_patterns()["shade_rows"])
    if t <= 0:
        return None
    return 100.0 * roofline("shade_rows").least_s(trace, window) / t
