"""Device-idle ms a presented frame during which the program's main
thread was inside one of its own spans (`lib/program.py`): of the idle
gaps between the stretch's device operations (`lib.profile.gaps`), the
time some program span was open, over the presents in the stretch (a
frame of the interactive loop, a recorded frame of the record loop). The
idle that is left is the harness's own time between calls. Split by the
cells' rate metric (`host_idle_ms.interactive`, `host_idle_ms.record`).
None where the program records no spans or they do not align."""

from portbench.lib.program import align


def read(trace, window):
    prog = align(trace)
    if prog is None or trace.presents == 0:
        return None
    split = prog.idle_by_span(trace)
    return 1e3 * (sum(split.values()) - split[""]) / trace.presents
