"""`tex_mip`'s model with a fifth texture layer, the light's own base
colour: with more than four layers every bounce samples level 0."""

from __future__ import annotations

from portbench.lib import spec


def glb() -> bytes:
    return spec.scene("tex_mip").build(fifth_layer=True)
