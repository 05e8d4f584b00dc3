"""Counter-seeded PCG, bit-identical to the JAX package's `ops/rng.py`.

A PCG word is a u32. PyTorch has no u32 arithmetic on the CPU (no `>>` or
`+` for uint32), so the port carries every word as an int64 tensor holding a
value in [0, 2**32) and masks after each operation that can leave that
range. Products of two such values wrap mod 2**64, which keeps the low 32
bits right. The CUDA shade kernel (`csrc/shade_rows.cu`) reads and writes
the same int64 words and computes in native `uint32_t`.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def init_rng(pixel_idx: torch.Tensor, frame) -> torch.Tensor:
    """Hash (pixel, frame) into a u32 PCG state (int64 tensor).

    `frame` is an int or a 0-d int64 tensor on the pixels' device (a
    captured frame step reads its frame count from the device); both give
    the JAX package's u32 words, which wrap mod 2**32 (the frame is reduced
    first, so the int64 product below cannot overflow)."""
    seed = (pixel_idx + (frame & M32) * 719393) & M32
    seed = seed ^ 2747636419
    seed = (seed * 2654435769) & M32
    seed = seed ^ (seed >> 16)
    seed = (seed * 2654435769) & M32
    seed = seed ^ (seed >> 16)
    return (seed * 2654435769) & M32


def frame_tensor(frame_count, device) -> torch.Tensor:
    """A frame count as a 0-d int64 tensor on `device`: a tensor as it is,
    an int through a fill (no host-to-device copy, so a frame step that is
    being captured may call this too)."""
    if isinstance(frame_count, torch.Tensor):
        return frame_count
    return torch.full((), frame_count, dtype=torch.int64, device=device)


def rand_pcg(state: torch.Tensor):
    """One PCG-RXS-M-XS draw: (new_state, uniform f32 in [0, 1]).

    The f32 draw is the correctly rounded word over f32(4294967295.0),
    which is 2**32: the product with 2**-32 below is that same IEEE
    division, exactly."""
    old = state
    state = (old * 747796405 + 2891336453) & M32
    word = (state >> ((old >> 28) + 4)) ^ state
    word = (word >> 22) ^ word
    return state, word.to(torch.float32) * 2.0 ** -32


def rand_n(state: torch.Tensor, n: int):
    """Draw n uniforms; returns (new_state, [u0, ..., un-1])."""
    outs = []
    for _ in range(n):
        state, u = rand_pcg(state)
        outs.append(u)
    return state, outs
