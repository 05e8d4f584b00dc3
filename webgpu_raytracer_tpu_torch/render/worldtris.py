"""World-space triangle tables for the port's dense sweep.

The numpy flatten of the JAX package's `render/worldtris.build_world_tris`,
re-stated without JAX: every instance's triangles go to world space once per
scene update, then

- `features` (16, 5*Tw) f32, columns grouped [s0 | s1 | s2 | tn | td]: the
  Plucker side tests s_k = f . [d, o x d], the plane numerator
  tn = f . [o, 1] and the denominator td = f . d of every triangle;
- `shade_table` (Tw, 40) f32, one shading row per world triangle in the
  SHADE_COLS layout;
- `light_rows` (Lpad, 40) f32, the shade rows of the emissive triangles
  padded to a multiple of 8;
- `light_count` and `valid_count` (host ints);
- `tex_slots` and `light_tex` (host bools): which of the four texture
  slots (base colour, metallic-roughness, normal, emissive) some real
  triangle binds, and whether some light row that NEE can pick binds a
  base-colour texture. The samplers skip a slot that is bound nowhere: the
  JAX package skips it at run time when no lane carries it, and these
  facts, known when the tables are built, give the same result without
  a host sync.

- `spheres` (n_tiles, 4) f32, one bounding sphere [cx, cy, cz, r] per
  tile of the sweep (r = -1 for an all-padding tile): the cull of the
  job-stream path (`ops/cluster_cull.py`) tests rays against them. A tile
  is 128 triangles, or the whole padded table when it holds 128 or fewer.
- `box` (6,) f32 [lo, hi]: the box of the live spheres
  (`ops/coherence.box6`), which the coherence sort and the culls read every
  sweep.

The TPU-only operands (the bf16x3 `featk3`/`shadek3` layouts, the packed
upload) have no counterpart here: the port's kernels read the f32 tables
directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.coherence import box6
from ..ops.fetch import device_pyramid

FEAT_K = 16

SHADE_COLS = dict(
    v0=(0, 3), e1=(3, 6), e2=(6, 9),
    n0=(9, 12), n1=(12, 15), n2=(15, 18),
    uv0=(18, 20), uv1=(20, 22), uv2=(22, 24),
    base_color=(24, 27), mat=(27, 28), mrir=(28, 31),
    tex=(31, 35), emissive=(35, 38), tri_idx=(38, 39), inst_idx=(39, 40),
)
SHADE_K = 40


class WorldTables(NamedTuple):
    """The sweep's and the shade pass's scene operands, on one device."""

    features: torch.Tensor     # (FEAT_K, 5 * Tw) f32
    shade_table: torch.Tensor  # (Tw, SHADE_K) f32
    light_rows: torch.Tensor   # (Lpad, SHADE_K) f32
    light_count: int
    valid_count: int
    spheres: torch.Tensor      # (n_tiles, 4) f32 [cx, cy, cz, r]
    box: torch.Tensor          # (6,) f32 [lo, hi] of the live spheres
    tex_slots: tuple = (True, True, True, True)
    light_tex: bool = True

    @property
    def device(self) -> torch.device:
        return self.features.device


def _round_up(n, m):
    return max(m, ((n + m - 1) // m) * m)


def tri_pad(tw: int) -> int:
    """Padded world-triangle count (the JAX package's rule): a multiple of 8
    up to 128 triangles, of 128 above."""
    return _round_up(tw, 8) if tw <= 128 else _round_up(tw, 128)


def tile_spheres(v0, e1, e2) -> np.ndarray:
    """Per-tile bounding spheres (n_tiles, 4) f32 [cx, cy, cz, r] of the
    padded triangles, r = -1 for an all-padding tile: the JAX package's
    `_np_tile_spheres` rule, bit for bit. Triangles arrive in BLAS-leaf
    order (spatially coherent), so a tile's sphere is tight enough to
    cull with."""
    twp = v0.shape[0]
    c = twp if twp < 128 else 128
    n_tiles = twp // c
    tri_valid = (np.abs(v0).sum(1) + np.abs(e1).sum(1)
                 + np.abs(e2).sum(1)) > 0
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (Twp, 3, 3)
    big = np.float32(3e38)
    vmask = tri_valid[:, None, None]
    lo = np.where(vmask, pts, big).reshape(n_tiles, -1, 3).min(axis=1)
    hi = np.where(vmask, pts, -big).reshape(n_tiles, -1, 3).max(axis=1)
    empty = lo[:, 0] > hi[:, 0]
    center = np.where(empty[:, None], 0.0, (lo + hi) * 0.5)
    r = np.where(empty, -1.0, np.linalg.norm(
        np.where(empty[:, None], 0.0, hi - center), axis=1))
    return np.concatenate([center, r[:, None]], axis=1).astype(np.float32)


def pos_norm(v):
    l = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(l > 0, v / np.maximum(l, 1e-20), v)


def world_tables_np(world) -> dict:
    """Flatten all instances' triangles to world space (numpy).

    Returns a dict of numpy arrays: features, shade_table, light_rows,
    light_count, valid_count, spheres."""
    topo = np.asarray(world.topology(), np.uint32).reshape(-1, 20)
    tri_v = topo[:, 0:3].astype(np.int64)
    tri_geom = topo[:, 3].astype(np.int64)
    attrs = topo[:, 4:20].copy().view(np.float32)
    pos = np.asarray(world.vertices(), np.float32).reshape(-1, 4)[:, :3]
    nrm = np.asarray(world.normals(), np.float32).reshape(-1, 4)[:, :3]
    uvs = np.asarray(world.uvs(), np.float32).reshape(-1, 2)

    inst = np.asarray(world.instances(), np.float32).reshape(-1, 36)
    n_inst = inst.shape[0]
    tf = inst[:, 0:16].reshape(n_inst, 4, 4).transpose(0, 2, 1)
    inv = inst[:, 16:32].reshape(n_inst, 4, 4).transpose(0, 2, 1)
    inst_geom = inst[:, 32:36].copy().view(np.uint32)[:, 2].astype(np.int64)

    lights = np.asarray(world.lights(), np.uint32).reshape(-1, 2) \
        .astype(np.int64)

    chunks = []
    light_wt = []
    base = 0
    for i in range(n_inst):
        sel = np.nonzero(tri_geom == inst_geom[i])[0]
        if sel.size == 0:
            continue
        rot = tf[i, :3, :3]
        trn = tf[i, :3, 3]
        nrm_m = inv[i, :3, :3].T  # normals: inverse-transpose

        vi = tri_v[sel]
        v0 = pos[vi[:, 0]] @ rot.T + trn
        v1 = pos[vi[:, 1]] @ rot.T + trn
        v2 = pos[vi[:, 2]] @ rot.T + trn
        nn0 = pos_norm(nrm[vi[:, 0]] @ nrm_m.T)
        nn1 = pos_norm(nrm[vi[:, 1]] @ nrm_m.T)
        nn2 = pos_norm(nrm[vi[:, 2]] @ nrm_m.T)

        # this instance's light triangles -> world-tri rows
        mine = lights[lights[:, 0] == i]
        if mine.size:
            lut = {int(t): k for k, t in enumerate(sel)}
            for _, t in mine:
                light_wt.append(base + lut[int(t)])
        base += sel.size
        chunks.append((sel, v0, v1, v2, nn0, nn1, nn2,
                       uvs[vi[:, 0]], uvs[vi[:, 1]], uvs[vi[:, 2]],
                       np.full(sel.size, i, np.int64)))

    if not chunks:
        # empty scene: one degenerate tri
        z3 = np.zeros((1, 3), np.float32)
        z2 = np.zeros((1, 2), np.float32)
        chunks = [(np.zeros(1, np.int64), z3, z3, z3, z3, z3, z3, z2, z2, z2,
                   np.zeros(1, np.int64))]

    (sel_all, v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, wt_inst) = (
        np.concatenate([c[k] for c in chunks]) for k in range(11))

    tw = v0.shape[0]
    tw_pad = tri_pad(tw)
    pad = tw_pad - tw

    def padf(a):
        if pad == 0:
            return a
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    v0, v1, v2 = padf(v0), padf(v1), padf(v2)
    n0, n1, n2 = padf(n0), padf(n1), padf(n2)
    uv0, uv1, uv2 = padf(uv0), padf(uv1), padf(uv2)
    sel_all = padf(sel_all)
    wt_inst = padf(wt_inst)

    a = attrs[np.clip(sel_all, 0, attrs.shape[0] - 1)]
    if pad:
        a[tw:] = 0.0

    e1 = v1 - v0
    e2 = v2 - v0

    # --- Plucker feature table: s_e for edge (a, b) = d.(a x b) + m.(b-a) ---
    def edge_cols(pa, pb):
        c = np.zeros((FEAT_K, tw_pad), np.float32)
        c[0:3] = np.cross(pa, pb).T          # dotted with d
        c[3:6] = (pb - pa).T                 # dotted with m
        return c

    n = np.cross(e1, e2)
    col_tn = np.zeros((FEAT_K, tw_pad), np.float32)
    col_tn[6:9] = -n.T                        # -n.o
    col_tn[9] = np.einsum("tj,tj->t", n, v0)  # + n.v0
    col_td = np.zeros((FEAT_K, tw_pad), np.float32)
    col_td[0:3] = n.T                         # n.d
    features = np.concatenate([edge_cols(v0, v1), edge_cols(v1, v2),
                               edge_cols(v2, v0), col_tn, col_td], axis=1)

    lw = np.asarray(light_wt, np.int64) if light_wt else np.zeros(1, np.int64)
    shade = np.concatenate(
        [v0, e1, e2, n0, n1, n2, uv0, uv1, uv2,
         a[:, 0:3], a[:, 3:4], a[:, 4:7], a[:, 8:12], a[:, 12:15],
         sel_all[:, None].astype(np.float32),
         wt_inst[:, None].astype(np.float32)],
        axis=1,
    ).astype(np.float32)
    assert shade.shape[1] == SHADE_K

    lw_padded = np.zeros(_round_up(len(lw), 8), np.int64)
    lw_padded[: len(lw)] = lw
    light_rows = shade[np.clip(lw_padded, 0, shade.shape[0] - 1)]

    return dict(features=features, shade_table=shade, light_rows=light_rows,
                light_count=np.int32(len(light_wt)), valid_count=np.int32(tw),
                spheres=tile_spheres(v0, e1, e2))


def tables_from_jax(np_dict: dict, device="cpu") -> WorldTables:
    """numpy tables keyed as the JAX package's `WorldTris` fields -> the
    port's WorldTables on `device`.

    `world_tables_np` returns these keys, and so do the JAX tables given as
    numpy (`{k: np.asarray(v) for k, v in wt._asdict().items()}`), which
    lets both packages compute on the same inputs. The JAX `spheres`
    (n_tiles, 1, 128) carry their first four columns."""
    def dev(name):
        return torch.from_numpy(np.array(np_dict[name], np.float32)).to(device)

    spheres = np.asarray(np_dict["spheres"], np.float32)
    if spheres.ndim == 3:
        spheres = spheres[:, 0, :4]

    light_count = int(np_dict["light_count"])
    valid_count = int(np_dict["valid_count"])
    lo = SHADE_COLS["tex"][0]
    tex = np.asarray(np_dict["shade_table"])[:valid_count, lo:lo + 4]
    light_tex = np.asarray(np_dict["light_rows"])[:max(light_count, 1), lo]
    spheres = torch.from_numpy(np.array(spheres, np.float32))
    return WorldTables(features=dev("features"),
                       shade_table=dev("shade_table"),
                       light_rows=dev("light_rows"),
                       light_count=light_count,
                       valid_count=valid_count,
                       spheres=spheres.to(device),
                       box=box6(spheres).to(device),
                       tex_slots=tuple(bool(b) for b in (tex >= 0).any(0)),
                       light_tex=bool((light_tex >= 0).any()))


def textures_from_jax(pyr, device="cpu") -> tuple:
    """The JAX package's `build_quad_pyramid` output, as numpy -> the
    port's (level0, level1) TexLevels on `device`.

    level1 is a `TexKron` (its `.flat` holds the quad words) or level 0
    itself; both packages then sample the same texels."""
    l0, l1 = pyr
    return device_pyramid((l0, l1 if l1 is l0 else l1.flat), device)


def build_world_tables(world, device) -> WorldTables:
    """Flatten `world` and upload its tables to `device`."""
    return tables_from_jax(world_tables_np(world), device)
