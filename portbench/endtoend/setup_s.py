"""Seconds from the start of the process until the window opens: imports,
the kernels' build or load, the scene compile and upload, and the
captures of every step key the window uses."""


def read(window):
    return window.setup_s
