"""Device ms a step of the sharded step's all-reduce on rank 0: the
profiler's device time of the NCCL kernels (`kernels/all_reduce.json`;
the harness's own collectives go over the host, so they are the program's
alone) over the steps in the stretch. The kernel runs from the moment its
graph reaches it until every rank's share has arrived, so the time holds
the wait for the slowest rank besides the transfer. None where no such
kernel ran."""

from portbench.lib.spec import kernel_patterns


def read(trace, window):
    t = trace.device_s(kernel_patterns()["all_reduce"])
    if trace.frames == 0 or t <= 0:
        return None
    return 1e3 * t / trace.frames
