"""Device ms a frame of the multi-tile narrow phase: the coherence sort's
library sort, the cull kernel and the job-sweep kernel, by kernel name,
over the frames in the stretch. The sort's plain-torch key and gather
kernels carry no name of their own and are left out."""

from portbench.lib.spec import kernel_patterns

SORT = "(?i)sort"


def read(trace, window):
    if trace.frames == 0 or trace.launches.get("job_sweep", 0) == 0:
        return None
    k = kernel_patterns()
    s = trace.device_s("|".join([SORT, k["cluster_cull"], k["job_sweep"]]))
    return 1e3 * s / trace.frames
