"""A user's textured model for the viewer preset: 16 textured UV spheres
of two materials, each turned its own way, and a textured emitter, five
layers.

- Each sphere is a 24 x 12 UV sphere built as the scene compiler's
  `add_sphere` builds one (`native/geometry.cpp`, the upstream's
  `geometry.rs:204-275`): 13 rings of 25 vertices from the +z pole down,
  UVs (j / 24, i / 12), normals the unit positions, no triangle at the
  poles' degenerate edge: 325 vertices, 528 triangles. A checkerboard of
  `tex_mip`'s metal material (base colour, metallic-roughness, normal
  map, and emissive under a factor of 0.0057, whose square stays below
  the scene compiler's light threshold, so no light) and its Lambertian
  material (base colour, normal map).
- `tex_mip`'s quad light (emissive factor 1), whose base colour is a
  fifth layer of its own, as `tex_full` has it: with more than four
  layers every bounce samples level 0.
- The spheres stand in a 4 x 4 grid on the room's floor, x and z in
  {-0.6, -0.2, 0.2, 0.6}. A sphere's radius s is 0.15-0.19 (a fixed
  pattern of its index), its centre's y is s (it rests on the floor), and
  its rotation turns the pole axis from +z to +y, then by 22.5 degrees
  times its index about +y, so the spheres' tangent frames differ.

The viewer gives every instance of a loaded model one transform, its demo
transform (a scale of 0.7, then half a turn about +y; `native/world.cpp`,
the upstream's `lib.rs:196-204`), in place of the glTF nodes' own. So a
node's transform cannot place a sphere: each sphere is a mesh of its own,
one node each, with its placement and the inverse of the demo transform
baked into its vertices and normals. The light's quad is `tex_mip`'s, as
that model places it.

16 x 528 + 2 model triangles and the room's 12: 67 tiles of 128, so every
sweep goes through the cull and the job narrow phase, and under the dense
path's 16,384-triangle limit on the CPU too.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.lib import gltf

EMISSIVE = 0.0057
SECTORS, STACKS = 24, 12
GRID = (-0.6, -0.2, 0.2, 0.6)
# The viewer's model transform (a uniform scale, then half a turn about
# +y), which the scene compiler gives every instance of a loaded model.
VIEWER_SCALE = 0.7


def sphere() -> tuple:
    """The unit UV sphere's positions, normals, UVs and indices."""
    pos, uv = [], []
    for i in range(STACKS + 1):
        v = i / STACKS
        stack = math.pi / 2 - math.pi * v
        xy, z = math.cos(stack), math.sin(stack)
        for j in range(SECTORS + 1):
            u = j / SECTORS
            sector = 2 * math.pi * u
            pos.append((xy * math.cos(sector), xy * math.sin(sector), z))
            uv.append((u, v))
    pos = np.asarray(pos, np.float32)
    nrm = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    idx = []
    for i in range(STACKS):
        k1 = i * (SECTORS + 1)
        k2 = k1 + SECTORS + 1
        for j in range(SECTORS):
            if i != 0:
                idx += [k1 + j, k2 + j, k1 + j + 1]
            if i != STACKS - 1:
                idx += [k1 + j + 1, k2 + j, k2 + j + 1]
    return (pos, nrm.astype(np.float32), np.asarray(uv, np.float32),
            np.asarray(idx, np.uint16))


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def placements() -> list:
    """(mesh material, world 3x3 linear part, world translation) of the
    16 spheres."""
    out = []
    for k in range(16):
        row, col = divmod(k, 4)
        s = 0.15 + 0.01 * ((3 * k) % 5)
        turn = _rot_y(math.radians(22.5 * k)) @ _rot_x(-math.pi / 2)
        out.append(((row + col) % 2, s * turn,
                    np.array([GRID[col], s, GRID[row]])))
    return out


def baked(linear: np.ndarray, shift: np.ndarray, ball: tuple) -> tuple:
    """The sphere's vertices and normals placed by (linear, shift) in the
    world, less the viewer's model transform, which the scene compiler
    then applies to every instance of a model."""
    undo = _rot_y(-math.pi) / VIEWER_SCALE
    a, b = undo @ linear, undo @ shift
    pos, nrm, uv, idx = ball
    n = nrm.astype(np.float64) @ np.linalg.inv(a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return ((pos.astype(np.float64) @ a.T + b).astype(np.float32),
            n.astype(np.float32), uv, idx)


def glb() -> bytes:
    images = [gltf.layer(11, lo=(60, 60, 60)),
              gltf.layer(23, lo=(0, 40, 0), hi=(0, 255, 255)),
              gltf.layer(37, lo=(70, 70, 230), hi=(186, 186, 255)),
              gltf.layer(41),
              gltf.layer(53, lo=(90, 90, 90))]
    materials = [
        {"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
            "baseColorTexture": {"index": 0},
            "metallicFactor": 1.0, "roughnessFactor": 1.0,
            "metallicRoughnessTexture": {"index": 1}},
         "normalTexture": {"index": 2},
         "emissiveTexture": {"index": 3},
         "emissiveFactor": [EMISSIVE] * 3},
        {"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0},
         "normalTexture": {"index": 2}},
        {"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 4},
            "metallicFactor": 0.0},
         "emissiveFactor": [1.0, 1.0, 1.0]},
    ]
    ball = sphere()
    meshes = [gltf.Mesh(*baked(a, b, ball), m) for m, a, b in placements()]
    meshes.append(gltf.Mesh(*gltf.quad((0.3, 1.1, 0.95), (0.0, 0.5, 0.0),
                                       (0.6, 0.0, 0.0)), 2))
    return gltf.model(meshes, materials, images)
