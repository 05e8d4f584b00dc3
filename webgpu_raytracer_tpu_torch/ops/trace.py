"""Progressive accumulation (the JAX package's `ops/trace.accumulate`)."""

from __future__ import annotations

import torch


def accumulate(prev_acc: torch.Tensor, col: torch.Tensor,
               frame_count: int) -> torch.Tensor:
    """Sum + count accumulation, (R, 4). The reset is semantic: frame 1
    overwrites, so a stale buffer never contributes."""
    sample = torch.cat([col, torch.ones_like(col[:, :1])], dim=-1)
    return prev_acc + sample if frame_count > 1 else sample
