"""Device-idle ms a recorded frame between its last sample's kernels and
the next frame's first: the time the device waits for the recorder's host
work between two frames (the present's copy, the PNG encode, the scene
tick and the upload). For each `present` span in the stretch, the idle
time between the end of the last operation launched from a
`render_frame` span before it and the start of the first launched from
one after it, averaged over the presents that have both."""

from portbench.lib.profile import gaps


def read(trace, window):
    samples = sorted((o.launch, o.start, o.end) for o in trace.ops
                     if o.span == "render_frame")
    spans = [(s, e) for name, s, e in trace.spans if name == "present"]
    busy = [(o.start, o.end) for o in trace.ops]
    idle = []
    for s, _ in spans:
        before = [x for x in samples if x[0] < s]
        after = [x for x in samples if x[0] > s]
        if before and after:
            a = max(x[2] for x in before)
            b = min(x[1] for x in after)
            if b > a:
                idle.append(sum(e - s0 for s0, e in gaps(busy, a, b)))
    if not idle:
        return None
    return 1e3 * sum(idle) / len(idle)
