"""% of its roofline that the single-tile sweep reaches over the profiled
stretch: the least time of its frames' work (`roofline/dense_sweep.py`)
over the profiler's device time of its kernels."""

from portbench.lib.spec import kernel_patterns, roofline


def read(trace, window):
    t = trace.device_s(kernel_patterns()["dense_sweep"])
    if t <= 0:
        return None
    return 100.0 * roofline("dense_sweep").least_s(trace, window) / t
