"""% of its roofline that the BVH bounce kernel reaches over the profiled
stretch: the least time of its frames' work (`roofline/bvh_shade.py`)
over the profiler's device time of its kernel."""

from portbench.lib.spec import kernel_patterns, roofline


def read(trace, window):
    t = trace.device_s(kernel_patterns()["bvh_shade"])
    if t <= 0:
        return None
    return 100.0 * roofline("bvh_shade").least_s(trace, window) / t
