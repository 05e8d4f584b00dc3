"""Device ms a presented frame of the present step: the profiler's device
time of the operations launched from inside the harness's `present` span
(the present graph's replay and the image's copy to the host), attributed
by the host call that launched them, over the presents in the stretch."""


def read(trace, window):
    s = sum(o.end - o.start for o in trace.ops if o.span == "present")
    if trace.presents == 0 or s <= 0:
        return None
    return 1e3 * s / trace.presents
