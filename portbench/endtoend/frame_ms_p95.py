"""The 95th percentile of every frame's wall ms in the window (a closed
loop: a frame starts when the one before it ended), over all its frames,
never from medians of chunks."""

from portbench.lib.window import percentile


def read(window):
    return percentile([1e3 * s for s in window.frame_s()], 95.0)
