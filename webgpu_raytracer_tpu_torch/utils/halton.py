"""Halton(2,3) sub-pixel jitter sequence.

The port's copy of the JAX package's `utils/halton.py`: the jitter index
is (frame_count % 16) + 1; jitter = (halton - 0.5) / dims; the average
jitter is the running mean used by the post-process un-jitter resample.
"""

from __future__ import annotations

import numpy as np


def halton(index: int, base: int) -> float:
    f = 1.0
    r = 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


def frame_jitter(frame_count: int, width: int, height: int):
    """Sub-pixel jitter in UV units for a given 1-based frame counter."""
    i = (frame_count % 16) + 1
    jx = (halton(i, 2) - 0.5) / width
    jy = (halton(i, 3) - 0.5) / height
    return np.array([jx, jy], dtype=np.float32)


class JitterAccumulator:
    """Tracks the running average jitter across accumulated frames."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.acc = np.zeros(2, dtype=np.float64)

    def step(self, frame_count: int):
        j = frame_jitter(frame_count, self.width, self.height)
        if frame_count == 1:
            self.acc = j.astype(np.float64)
        else:
            self.acc = self.acc + j
        avg = (self.acc / frame_count).astype(np.float32)
        return j, avg
