"""What one run's window gives the readers of its metrics."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Window:
    """The measured window of one run.

    `ends` are the host clock's readings (seconds) at the end of each
    completed frame (a recorded frame in the record loop), `t_open` the
    reading at which the window opened: a frame of a closed loop starts
    when the one before it ended, so the frames' times are the
    differences of successive readings and together fill the window."""

    setup_s: float
    t_open: float
    ends: list
    rays: float                 # exact rays traced in the window
    pixels: int                 # pixels of one frame
    tris: int                   # world triangles
    light_rows: int             # emissive triangles
    snapshots: list = field(default_factory=list)
    trace: object = None        # lib.profile.Trace of a traced run
    memory_peak_bytes: int = 0
    phases: dict = field(default_factory=dict)  # set-up's steps, seconds

    @property
    def frames(self) -> int:
        return len(self.ends)

    @property
    def window_s(self) -> float:
        return self.ends[-1] - self.t_open if self.ends else 0.0

    def frame_s(self) -> list:
        """Every frame's wall seconds, in order."""
        out, at = [], self.t_open
        for e in self.ends:
            out.append(e - at)
            at = e
        return out


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linearly interpolated
    between the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
