"""Mrays/s: every ray the window traced (the program's exact device count
of each frame, primaries plus the NEE shadow and extension lanes swept,
summed on the device and read once after the window) over the window's
wall seconds, / 1e6. The output check holds the count of its checked
frames to the reference's."""


def read(window):
    return window.rays / window.window_s / 1e6
