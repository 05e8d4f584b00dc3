"""Device-side scene resources of the BVH path.

The port of the JAX package's `render/resources.py`: the scene compiler's
flat buffers unpacked into structure-of-arrays tensors on one device, with
the same static padding (padded nodes have min 0, max -1 and a skip past
the end; padded triangles carry no texture; padded vertices are zero).

BLAS skip pointers are geometry-relative in the flat contract; here they
are absolutized into the merged TLAS+BLAS node array, so a walk over the
two levels (`ops/intersect.py`, `csrc/bvh_walk.cu`) moves by assigning a
cursor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fetch import TexLevel
from ..utils.textures import pack_quad_table


class DeviceScene(NamedTuple):
    """All scene state the BVH tracer reads, as tensors on one device."""

    # Merged TLAS+BLAS nodes (TLAS first). Skips are absolute indices.
    node_min: torch.Tensor   # (N, 3) f32
    node_max: torch.Tensor   # (N, 3) f32
    node_skip: torch.Tensor  # (N,) int32, absolutized
    node_data: torch.Tensor  # (N,) int32: 0 = internal, else (first<<3)|count
    tlas_count: int          # end sentinel of the TLAS walk

    # Topology (per triangle)
    tri_v: torch.Tensor          # (T, 3) int32 global vertex indices
    tri_base_color: torch.Tensor  # (T, 3) f32
    tri_mat: torch.Tensor        # (T,) int32: lambertian/metal/dielectric/light
    tri_mrir: torch.Tensor       # (T, 3) f32: metallic, roughness, ior
    tri_tex: torch.Tensor        # (T, 4) int32: base/metrough/normal/emissive
    tri_emissive: torch.Tensor   # (T, 3) f32

    # Geometry
    pos: torch.Tensor  # (V, 3) f32
    nrm: torch.Tensor  # (V, 3) f32
    uv: torch.Tensor   # (V, 2) f32

    # Instances (TLAS-sorted)
    inst_tf: torch.Tensor    # (I, 4, 4) f32, p' = M @ [p, 1]
    inst_inv: torch.Tensor   # (I, 4, 4) f32
    inst_blas: torch.Tensor  # (I,) int32 absolute root index

    # Lights
    lights: torch.Tensor  # (L, 2) int32 [instance, triangle]
    light_count: int

    # The level-0 quad table (K, TH, TW, 4) int32, or the (1, 1, 1, 3) f32
    # white placeholder.
    textures: torch.Tensor


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def absolutize_blas_skips(blas_skip_u32: np.ndarray,
                          tlas_count: int) -> np.ndarray:
    """Per-geometry-relative BLAS skips -> merged-array-absolute.

    Each geometry's BLAS segment starts at its root, whose skip equals the
    segment's node count, so the segments are found by walking the roots."""
    n = len(blas_skip_u32)
    out = np.empty(n, dtype=np.int64)
    start = 0
    while start < n:
        count = int(blas_skip_u32[start])
        if count <= 0:  # a malformed segment: end the walk there
            out[start:] = tlas_count + n
            break
        seg = slice(start, start + count)
        out[seg] = blas_skip_u32[seg].astype(np.int64) + tlas_count + start
        start += count
    return out


def unpack_instances(flat: np.ndarray):
    """(I*36,) f32 -> (tf, inv, blas_offset, geometry id) per instance.

    The first 16 floats are the transform's 4 columns; they are transposed
    to math-matrix order (row i = output component)."""
    inst = flat.reshape(-1, 36)
    count = inst.shape[0]
    tf = inst[:, 0:16].reshape(count, 4, 4).transpose(0, 2, 1).copy()
    inv = inst[:, 16:32].reshape(count, 4, 4).transpose(0, 2, 1).copy()
    meta = inst[:, 32:36].copy().view(np.uint32)
    return tf, inv, meta[:, 0].astype(np.int64), meta[:, 2].astype(np.int64)


def _texture_table(textures, device) -> torch.Tensor:
    """The level-0 quad table as a (K, TH, TW, 4) int32 tensor, or the
    white placeholder. Takes a TexLevel, raw (K, S, S, 3) f32 layers
    (packed here), or None."""
    if textures is None:
        return torch.ones((1, 1, 1, 3), dtype=torch.float32, device=device)
    if isinstance(textures, TexLevel):
        return textures.flat.view(*textures.shape, 4).to(device)
    quad = pack_quad_table(np.asarray(textures, np.float32))
    return torch.from_numpy(quad.astype(np.int32)).to(device)


def build_device_scene(world, pad_nodes_to: int = 256,
                       pad_tris_to: int = 256, pad_verts_to: int = 256,
                       textures=None, device="cuda") -> DeviceScene:
    """Unpack a NativeWorld's flat buffers into a padded DeviceScene on
    `device` (the card unless the caller passes a CPU device)."""
    tlas = np.asarray(world.tlas(), dtype=np.float32).reshape(-1, 8)
    blas = np.asarray(world.blas(), dtype=np.float32).reshape(-1, 8)
    tlas_count = tlas.shape[0]

    tlas_skip = tlas[:, 3].copy().view(np.uint32).astype(np.int64)
    blas_skip = absolutize_blas_skips(blas[:, 3].copy().view(np.uint32),
                                      tlas_count)
    merged_min = np.concatenate([tlas[:, 0:3], blas[:, 0:3]], axis=0)
    merged_max = np.concatenate([tlas[:, 4:7], blas[:, 4:7]], axis=0)
    merged_skip = np.concatenate([tlas_skip, blas_skip], axis=0)
    merged_data = np.concatenate(
        [tlas[:, 7].copy().view(np.uint32).astype(np.int64),
         blas[:, 7].copy().view(np.uint32).astype(np.int64)], axis=0)

    n_nodes = merged_min.shape[0]
    n_pad = _round_up(n_nodes, pad_nodes_to)
    if n_pad > n_nodes:
        pad = n_pad - n_nodes
        merged_min = np.concatenate([merged_min,
                                     np.zeros((pad, 3), np.float32)])
        merged_max = np.concatenate([merged_max,
                                     np.full((pad, 3), -1.0, np.float32)])
        merged_skip = np.concatenate([merged_skip,
                                      np.full(pad, n_pad, np.int64)])
        merged_data = np.concatenate([merged_data, np.zeros(pad, np.int64)])

    # Topology: stride-20 u32 records
    topo = np.asarray(world.topology(), dtype=np.uint32).reshape(-1, 20)
    t_count = topo.shape[0]
    tri_v = topo[:, 0:3].astype(np.int64)
    attrs = topo[:, 4:20].copy().view(np.float32)
    base_color = attrs[:, 0:3].copy()
    mat = (attrs[:, 3] + 0.5).astype(np.int64)
    mrir = attrs[:, 4:7].copy()
    tex = attrs[:, 8:12].astype(np.int64)  # -1 encoded as -1.0 f32
    emissive = attrs[:, 12:15].copy()

    t_pad = _round_up(t_count, pad_tris_to)
    if t_pad > t_count:
        pad = t_pad - t_count
        tri_v = np.concatenate([tri_v, np.zeros((pad, 3), np.int64)])
        base_color = np.concatenate([base_color,
                                     np.zeros((pad, 3), np.float32)])
        mat = np.concatenate([mat, np.zeros(pad, np.int64)])
        mrir = np.concatenate([mrir, np.zeros((pad, 3), np.float32)])
        tex = np.concatenate([tex, -np.ones((pad, 4), np.int64)])
        emissive = np.concatenate([emissive, np.zeros((pad, 3), np.float32)])

    # Geometry
    pos = np.asarray(world.vertices(), np.float32).reshape(-1, 4)[:, :3]
    nrm = np.asarray(world.normals(), np.float32).reshape(-1, 4)[:, :3]
    uv = np.asarray(world.uvs(), np.float32).reshape(-1, 2)
    v_count = pos.shape[0]
    v_pad = _round_up(v_count, pad_verts_to)
    if v_pad > v_count:
        pad = v_pad - v_count
        pos = np.concatenate([pos, np.zeros((pad, 3), np.float32)])
        nrm = np.concatenate([nrm, np.zeros((pad, 3), np.float32)])
        uv = np.concatenate([uv, np.zeros((pad, 2), np.float32)])

    tf, inv, blas_off, _geom = unpack_instances(
        np.asarray(world.instances(), np.float32))
    inst_blas_abs = blas_off + tlas_count

    lights = np.asarray(world.lights(), np.uint32).reshape(-1, 2) \
        .astype(np.int64)
    light_count = lights.shape[0]
    if light_count == 0:
        lights = np.zeros((1, 2), np.int64)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
            .to(device)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)) \
            .to(device)

    return DeviceScene(
        node_min=f32(merged_min), node_max=f32(merged_max),
        node_skip=i32(merged_skip), node_data=i32(merged_data),
        tlas_count=int(tlas_count),
        tri_v=i32(tri_v), tri_base_color=f32(base_color), tri_mat=i32(mat),
        tri_mrir=f32(mrir), tri_tex=i32(tex), tri_emissive=f32(emissive),
        pos=f32(pos), nrm=f32(nrm), uv=f32(uv),
        inst_tf=f32(tf), inst_inv=f32(inv), inst_blas=i32(inst_blas_abs),
        lights=i32(lights), light_count=int(light_count),
        textures=_texture_table(textures, device))
