"""Scene model families.

The port's copy of the JAX package's `models/presets.py`. The native
scene compiler (models/native.py -> native/presets.cpp) provides six
procedural presets with capability parity to the reference's factory
(rust-shader-tools/src/scene/{factory,procedural}.rs):

- cornell : classic Cornell box; two rotated boxes or a loaded OBJ on a
            pedestal (exercises diffuse GI)
- spheres : ray-tracing-in-one-weekend final scene, ~480 spheres with
            depth of field (the large-scene / BVH-backend stressor)
- mixed   : metal floor, two colored area lights, glass shell sphere, ring
            of metal/diffuse objects (exercises every material branch)
- special : metal-floor Cornell with a glass tall box and a small emissive
            sphere (caustics + tiny-light NEE)
- mesh    : OBJ cube instancing demo on a giant ground sphere
- viewer  : Cornell environment + loaded model (.obj/.glb/.vrm) or a
            magenta placeholder sphere; the target for model viewing

Model loading: pass `obj_source=` (Wavefront OBJ text) or `glb_data=`
(GLB/VRM bytes) to NativeWorld / Renderer. VRM files are GLB containers and
load through the same path (reference UIManager.ts:91, main.ts:246-257).
"""

from __future__ import annotations

PRESETS = ("cornell", "spheres", "mixed", "special", "mesh", "viewer")


def load_preset(name: str, obj_source: str | None = None,
                glb_data: bytes | None = None):
    """Create a NativeWorld for a preset (factory semantics: unknown names
    fall back to cornell, like the reference factory)."""
    from .native import NativeWorld

    return NativeWorld(name, obj_source, glb_data)
