"""A small textured model for the viewer preset, with four texture layers.

Two boxes on the viewer room's floor and a textured emitter facing the
camera, 26 triangles:

- a metal box whose material binds all four slots: base colour (layer 0),
  metallic-roughness (layer 1: roughness in G, metallic in B), normal map
  (layer 2) and emissive (layer 3, under an emissive factor of 0.0057,
  whose square stays below the scene compiler's light threshold of 1e-4,
  so the box is no light);
- a Lambertian box with base colour and normal map;
- a quad light (emissive factor 1) whose base colour is layer 0, so that
  both a hit on it and a light sample of it read a texture.

UVs run over [-0.25, 1.75] on the boxes (the repeat wrap). With at most
four layers, bounces past the first sample the 128^2 box mip; `tex_full`
is the same model with a fifth layer, where every bounce samples level 0.
"""

from __future__ import annotations

from portbench.lib import gltf

EMISSIVE = 0.0057


def build(fifth_layer: bool) -> bytes:
    """The GLB; with `fifth_layer` the light's base colour is a layer of its
    own (five layers), else it shares the metal box's (four)."""
    images = [gltf.layer(11, lo=(60, 60, 60)),
              gltf.layer(23, lo=(0, 40, 0), hi=(0, 255, 255)),
              gltf.layer(37, lo=(70, 70, 230), hi=(186, 186, 255)),
              gltf.layer(41)]
    light_tex = 0
    if fifth_layer:
        images.append(gltf.layer(53, lo=(90, 90, 90)))
        light_tex = 4
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
            "baseColorTexture": {"index": light_tex},
            "metallicFactor": 0.0},
         "emissiveFactor": [1.0, 1.0, 1.0]},
    ]
    meshes = [
        gltf.Mesh(*gltf.box((-0.35, 0.45, 0.2), (0.3, 0.45, 0.3)), 0),
        gltf.Mesh(*gltf.box((0.4, 0.3, -0.1), (0.25, 0.3, 0.25)), 1),
        gltf.Mesh(*gltf.quad((0.3, 1.1, 0.95), (0.0, 0.5, 0.0),
                             (0.6, 0.0, 0.0)), 2),
    ]
    return gltf.model(meshes, materials, images)


def glb() -> bytes:
    return build(fifth_layer=False)
