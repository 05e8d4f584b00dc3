"""% of its roofline that the BVH walk reaches over the profiled stretch:
the least time of its frames' work (`roofline/bvh_walk.py`) over the
profiler's device time of the closest and any-hit walk kernels."""

from portbench.lib.spec import kernel_patterns, roofline


def read(trace, window):
    t = trace.device_s(kernel_patterns()["bvh_walk"])
    if t <= 0:
        return None
    return 100.0 * roofline("bvh_walk").least_s(trace, window) / t
