"""Host ms a recorded frame inside the program's `record.png` span (the
PNG encode of the presented image), clipped to the profiled stretch, over
the recorded frames (presents) in it. None where the program records no
such span or the spans do not align (`lib/program.py`)."""

from portbench.lib.program import align


def read(trace, window):
    prog = align(trace)
    if prog is None or trace.presents == 0:
        return None
    png = [e - s for name, s, e in prog.clipped(trace.t0, trace.t1)
           if name == "record.png"]
    if not png:
        return None
    return 1e3 * sum(png) / trace.presents
