"""Defaults and render configuration.

The port's copy of the JAX package's `config.py`: the interactive
defaults and `RenderConfig`, the record serialized to distributed workers.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Optional

# Interactive defaults
DEFAULT_WIDTH = 720
DEFAULT_HEIGHT = 480
DEFAULT_MAX_DEPTH = 10
DEFAULT_SPP = 1
DEFAULT_UPDATE_INTERVAL = 4  # scene update every N frames

# Recording defaults
DEFAULT_FPS = 30
DEFAULT_DURATION_S = 3.0
DEFAULT_RECORD_SPP = 64
DEFAULT_BATCH = 4
DEFAULT_JOB_BATCH = 20  # frames per distributed job


@dataclass
class RenderConfig:
    """Full render configuration, serializable to distributed workers."""

    width: int = DEFAULT_WIDTH
    height: int = DEFAULT_HEIGHT
    fps: int = DEFAULT_FPS
    duration: float = DEFAULT_DURATION_S
    spp: int = DEFAULT_RECORD_SPP          # samples per recorded frame
    batch: int = DEFAULT_BATCH             # dispatches per GPU batch
    job_batch: int = DEFAULT_JOB_BATCH     # frames per distributed job
    anim_index: int = 0
    update_interval: int = DEFAULT_UPDATE_INTERVAL  # scene tick cadence
    max_depth: int = DEFAULT_MAX_DEPTH
    shader_spp: int = DEFAULT_SPP          # per-dispatch spp
    scene_name: str = "cornell"
    file_type: Optional[str] = None        # "obj" | "glb" | None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RenderConfig":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})
