"""Device ms a seeded frame of the G-buffer pass: in each frame step of
the stretch that launches the seed-row fetch (`kernels/fetch_rows.json`,
one launch in a frame seeded from the G-buffer, none in a traced one),
the device time of the operations that ran before that fetch, over the
frames that launched one.

A frame step is one CUDA graph: its operations share the host launch of
the graph's replay, so the frame's input fills, launched from the host
before the replay, are not counted. Before the fetch the graph holds the
G-buffer pass: the primary rays' sort, cull and job sweep (a dense sweep
on a one-tile scene), the plain-torch shading of every pixel with its
texel-quad fetches, and the ray count of the G-buffer's primaries. None
where no frame launched the fetch."""

import re

from portbench.lib.spec import kernel_patterns


def read(trace, window):
    fetch = re.compile(kernel_patterns()["fetch_rows"])
    steps: dict = {}
    for o in trace.ops:
        if o.launch is not None:
            steps.setdefault(o.launch, []).append(o)
    frames = []
    for ops in steps.values():
        at = [o.start for o in ops if fetch.search(o.name)]
        if at:
            frames.append(sum(o.end - o.start for o in ops
                              if o.start < min(at)))
    if not frames:
        return None
    return 1e3 * sum(frames) / len(frames)
