"""ms a frame: the window's wall ms over the frames completed in it. A
frame is `render_frame()` + `present()` and ends when `present()` has
returned the 8-bit image to the host."""


def read(window):
    return 1e3 * window.window_s / window.frames
