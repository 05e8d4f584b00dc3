"""% of the profiled stretch in which no operation ran on the device:
1 - (the union of the device operations' intervals) / (the stretch). One
reader for every cell; the metric is split by the cells' rate metric
(`idle_share.interactive`, `idle_share.record`)."""


def read(trace, window):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
