"""Component-SoA 3-vectors: (R,) tensors per component.

The port keeps the JAX package's lane-minor layout (`ops/v3.py` there), so
per-ray state and shade rows compare like with like, and every op is a
full-width elementwise op over the lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, on any device.

    CUDA's sqrtf is correctly rounded, and so is XLA's; ATen's vectorized
    CPU kernel is not (it misses by one ulp on ~0.7% of inputs). On the
    CPU the root is taken in f64, whose rounding to f32 is exact for sqrt
    (53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def length(a: V3):
    return sqrt_rn(dot(a, a))


def normalize(a: V3) -> V3:
    inv = 1.0 / torch.clamp(length(a), min=1e-20)
    return a * inv


def where(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def max_component(a: V3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def rows(a, lo: int) -> V3:
    """Rows lo..lo+2 of a (K, R) lane-minor table as a V3."""
    return V3(a[lo], a[lo + 1], a[lo + 2])
