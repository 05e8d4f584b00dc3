"""One BVH bounce on a row state: the plain `bvh_shade_step` and the CUDA
kernel `csrc/bvh_shade.cu`.

The bounce of the JAX package's `ops/trace.py::ray_color` (its `fori_loop`
body), which XLA compiles into one program: the hit rebuilt from the closest
walk's (tri, inst) with `load_hit`, emissive light with MIS, a NEE light
sample and its shadow ray, Lambert / GGX / dielectric sampling with the
geometric-normal guard, and Russian roulette after depth 3. Six PCG draws a
bounce on every lane, in `ray_color`'s order: 3 NEE, 2 BSDF, 1 RR.

The shadow walk runs after the shade, so a bounce's NEE contribution is
kept as pending and resolved by the next bounce's shade (or the loop's last
fold) with that walk's verdict, before the next emission: `ray_color`'s
order of sums. The gate is a select, so an infinite contribution on an
occluded lane adds nothing.

`bvh_shade_step` reuses `ops/trace.py`'s `load_hit`, `sample_light_source`,
`get_light_pdf`, `sample_texture` and `ops/bsdf.py`, so `ray_color_rows`
over it equals `ray_color` bit for bit. It is not the dense path's shade:
that one samples textures through `bsdf_v3` and the f64 lerps of
`ops/fetch.py`.

State rows (f32, (NS, R) lane-minor), in and out:
   0-2 throughput   3-5 radiance   6 prev_pdf   7 specular_bounce
   8-10 pending NEE contribution   11 pend (1: taken unless occluded)
  12 rays walked after the lane's primary (shadow and extension lanes)

Per-lane inputs beside the state: the walked ray (ro, rd (R, 3) f32), the
lanes that walked it (`active` (R,) bool, None for every lane), the closest
walk's (tri, inst) (R,) int32, the last shadow walk's `occluded` (R,) bool
(None before the first), and the rng words (R,) int64 (u32 values, see
ops/rng.py). The outputs `Bounce` are the walks' inputs as they read them:
contiguous (R, 3) rays, (R,) t_max and (R,) bool masks; rays of lanes that
do not walk are zero.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from . import bsdf
from .bsdf import PI, dot, norm, power_heuristic
from .rng import rand_n, rand_pcg
from .trace import (_col, _offset_eps, _rows, get_light_pdf, load_hit,
                    sample_light_source, sample_texture)

NS = 13
THROUGHPUT, RADIANCE, PREV_PDF, SPECULAR, PENDING, PEND, RAYS = (
    0, 3, 6, 7, 8, 11, 12)
# State rows that hold 0/1 flags
FLAG_ROWS = (SPECULAR, PEND)


class Bounce(NamedTuple):
    ro: torch.Tensor        # (R, 3) the extension ray (zero unless do_next)
    rd: torch.Tensor        # (R, 3)
    do_next: torch.Tensor   # (R,) bool: the lane walks its extension ray
    sro: torch.Tensor       # (R, 3) the shadow ray (zero unless nee_lane)
    srd: torch.Tensor       # (R, 3)
    s_tmax: torch.Tensor    # (R,) f32
    nee_lane: torch.Tensor  # (R,) bool: the lane walks its shadow ray


def initial_state(R: int, device) -> torch.Tensor:
    """Bounce 0's state: throughput 1, specular, nothing pending."""
    state = torch.zeros((NS, R), dtype=torch.float32, device=device)
    state[THROUGHPUT:THROUGHPUT + 3] = 1.0
    state[SPECULAR] = 1.0
    return state


def resolve(state, occluded) -> torch.Tensor:
    """The radiance (3, R) with the pending NEE contribution added where
    it was not occluded (a select)."""
    take = state[PEND] > 0.5
    if occluded is not None:
        take = take & ~occluded
    return state[RADIANCE:RADIANCE + 3] + torch.where(
        take, state[PENDING:PENDING + 3], 0.0)


def bvh_shade_step(scene, state, rng, ro, rd, active, tri, inst, occluded,
                   depth: int, max_depth: int):
    """One bounce over (R,) lanes, plain PyTorch: (state (NS, R), rng,
    Bounce). `ray_color`'s body operation for operation; every branch on
    every lane, combined with selects."""
    R = ro.shape[0]
    throughput = state[THROUGHPUT:THROUGHPUT + 3].T
    prev_pdf = state[PREV_PDF]
    specular_bounce = state[SPECULAR] > 0.5
    # The previous bounce's NEE, then this bounce's emission.
    radiance = resolve(state, occluded).T

    found = inst >= 0 if active is None else active & (inst >= 0)
    hit_t, tex_uv, s_normal, s_geom, albedo = load_hit(scene, ro, rd, tri,
                                                       inst)
    mat = _rows(scene.tri_mat, tri)
    mrir = _rows(scene.tri_mrir, tri)
    tex = _rows(scene.tri_tex, tri)
    emissive0 = _rows(scene.tri_emissive, tri)

    hit_p = ro + rd * hit_t[:, None]
    normal = torch.where(_col(dot(rd, s_normal) < 0.0), s_normal, -s_normal)
    geom_n = torch.where(_col(dot(rd, s_geom) < 0.0), s_geom, -s_geom)

    mr = sample_texture(scene.textures, tex[:, 1], tex_uv)
    metallic = torch.where(tex[:, 1] >= 0, mrir[:, 0] * mr[:, 2], mrir[:, 0])
    roughness = torch.where(tex[:, 1] >= 0, mrir[:, 1] * mr[:, 1],
                            mrir[:, 1])
    roughness = torch.clamp(roughness, min=0.005)
    ior = mrir[:, 2]
    emissive = emissive0 * torch.where(
        _col(tex[:, 3] >= 0),
        sample_texture(scene.textures, tex[:, 3], tex_uv), 1.0)
    f0 = 0.04 + (albedo - 0.04) * metallic[:, None]

    # Emissive / light hit, MIS-weighted.
    is_light = mat == 3
    has_em = is_light | (norm(emissive) > 1e-4)
    em_val = torch.where(_col(is_light), albedo, emissive)
    light_pdf = get_light_pdf(scene, tri, inst, hit_t, rd)
    mis_w = torch.where(specular_bounce, 1.0,
                        power_heuristic(prev_pdf, light_pdf))
    radiance = radiance + torch.where(
        _col(found & has_em), throughput * em_val * mis_w[:, None], 0.0)
    live = found & ~is_light

    # NEE: the shadow ray, and its contribution kept as pending.
    rng, (r0, r1, r2) = rand_n(rng, 3)
    ls = sample_light_source(scene, hit_p, r0, r1, r2)
    nee_lane = live & (mat != 2) & (ls.pdf > 0.0)
    eps = _offset_eps(hit_p)
    s_tmax = ls.dist - 2.0 * torch.maximum(
        eps, _offset_eps(hit_p + ls.dir * ls.dist[:, None]))
    n_dot_l = torch.clamp(dot(normal, ls.dir), min=0.0)
    bsdf_diff = bsdf.eval_diffuse(albedo)
    pdf_diff = n_dot_l / PI
    bsdf_metal = bsdf.eval_ggx(normal, -rd, ls.dir, roughness, f0)
    pdf_metal = bsdf.ggx_pdf(normal, -rd, ls.dir, roughness)
    bsdf_val = torch.where(_col(mat == 0), bsdf_diff, bsdf_metal)
    bsdf_pdf = torch.where(mat == 0, pdf_diff, pdf_metal)
    contrib = throughput * bsdf_val * ls.L * (
        power_heuristic(ls.pdf, bsdf_pdf) * n_dot_l
        / torch.clamp(ls.pdf, min=1e-20))[:, None]
    pend = nee_lane & (bsdf_pdf > 0.0)

    # BSDF sampling.
    rng, (s1, s2) = rand_n(rng, 2)
    sc_d = bsdf.sample_diffuse(normal, albedo, s1, s2)
    sc_m = bsdf.sample_ggx(normal, -rd, roughness, f0, s1, s2)
    sc_g = bsdf.sample_dielectric(rd, normal, ior, albedo, s1)
    is_m = mat == 1
    is_g = mat == 2

    def pick(g, m, d):
        if g.dim() == 2:
            return torch.where(_col(is_g), g, torch.where(_col(is_m), m, d))
        return torch.where(is_g, g, torch.where(is_m, m, d))

    dirn = pick(sc_g.dir, sc_m.dir, sc_d.dir)
    pdf = pick(sc_g.pdf, sc_m.pdf, sc_d.pdf)
    tp = pick(sc_g.throughput, sc_m.throughput, sc_d.throughput)
    is_spec = pick(sc_g.is_specular, sc_m.is_specular, sc_d.is_specular)

    # Geometric-normal guard for non-dielectrics.
    bad = (mat != 2) & (dot(dirn, geom_n) <= 0.0)
    pdf = torch.where(bad, 0.0, pdf)
    tp = torch.where(_col(bad), 0.0, tp)

    live = live & (pdf > 0.0) & (norm(tp) > 0.0)
    throughput = torch.where(_col(live), throughput * tp, throughput)
    off_n = torch.where(_col(dot(dirn, geom_n) > 0.0), geom_n, -geom_n)
    new_ro = hit_p + off_n * eps[:, None]
    prev_pdf = torch.where(live, pdf, prev_pdf)
    specular_bounce = torch.where(live, is_spec, specular_bounce)

    # Russian roulette after depth 3.
    rng, rr = rand_pcg(rng)
    p = throughput.amax(dim=-1)
    do_rr = live & (depth > 3)
    live = live & ~(do_rr & (rr > p))
    throughput = torch.where(
        _col(do_rr & (rr <= p)),
        throughput / torch.clamp(p, min=1e-20)[:, None], throughput)
    do_next = live & (depth < max_depth - 1)

    state_out = torch.cat([
        throughput.T, radiance.T, prev_pdf[None],
        specular_bounce.float()[None],
        torch.where(pend, contrib.T, 0.0), pend.float()[None],
        (state[RAYS] + nee_lane.float() + do_next.float())[None]])
    zero = torch.zeros((R, 3), dtype=torch.float32, device=ro.device)
    nxt = Bounce(torch.where(_col(do_next), new_ro, zero),
                 torch.where(_col(do_next), dirn, zero), do_next,
                 torch.where(_col(nee_lane), hit_p + geom_n * eps[:, None],
                             zero),
                 torch.where(_col(nee_lane), ls.dir, zero),
                 torch.where(nee_lane, s_tmax, 0.0), nee_lane)
    return state_out, rng, nxt


# The kernel's packed records (`pack_shade`): (field, 32-bit words) in
# record order, None a zero word; `csrc/bvh_shade.cu` reads each field at
# its first word (kP ... there, `layout_words`). A field of the vertices
# ("p", "n", "uv") holds the triangle's three vertices' rows in vertex
# order. A triangle: its vertices' object-space positions (not the walk's
# e1 / e2: the hit's world corners transform each vertex), normals and
# texture coordinates, then its material rows; 160 bytes.
TRI_LAYOUT = (("p", 9), ("n", 9), ("uv", 6), ("base_color", 3), ("mat", 1),
              ("mrir", 3), (None, 1), ("tex", 4), ("emissive", 3), (None, 1))
# A light row: its triangle's world corners v (`trace._light_tri_world`'s
# bits), texture coordinates, base colour and base-colour texture slot.
LIGHT_LAYOUT = (("v", 9), ("uv", 6), ("base_color", 3), ("tex", 1),
                (None, 1))
# An instance: rows 0-2 of inst_inv, then rows 0-2 of inst_tf.
INST_LAYOUT = (("inst_inv", 12), ("inst_tf", 12))


def layout_words(layout) -> dict:
    """{field: (first word, words)} of a record layout."""
    out, w = {}, 0
    for name, width in layout:
        if name is not None:
            out[name] = (w, width)
        w += width
    return out


class _Scene(ctypes.Structure):
    """A ShadePack as `csrc/bvh_shade.cu` reads it (`BvhScene`)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tris", "lights", "insts", "textures")] + [
        (name, ctypes.c_int) for name in (
            "n_tri", "n_inst", "light_count", "tex_k", "tex_h", "tex_w")]


class ShadePack(NamedTuple):
    """A DeviceScene as `csrc/bvh_shade.cu` reads it: one 16-byte-aligned
    record a triangle, a light row and an instance, with the tables' bits
    (`TRI_LAYOUT`, `LIGHT_LAYOUT`, `INST_LAYOUT`), and the texture table.
    On CUDA also the kernel's view of it, checked when it was built."""

    tris: torch.Tensor    # (T, 40) int32
    lights: torch.Tensor  # (L, 20) int32
    insts: torch.Tensor   # (I, 24) int32
    textures: torch.Tensor
    light_count: int
    view: _Scene | None   # the kernel's struct (CUDA), None on the CPU
    textured: bool        # the textures are a level-0 quad table


def _records(layout, cols: dict) -> torch.Tensor:
    """(n, words) int32 records of `layout`: each field's columns as 32-bit
    words, zero words for None. One cat, no host sync."""
    col0 = next(iter(cols.values()))
    n, dev = col0.shape[0], col0.device
    parts = []
    for name, width in layout:
        if name is None:
            parts.append(torch.zeros((n, width), dtype=torch.int32,
                                     device=dev))
            continue
        col = cols[name].reshape(n, width)
        parts.append(col.view(torch.int32) if col.is_floating_point()
                     else col.to(torch.int32))
    return torch.cat(parts, dim=1)


def _world_corners(scene, tri_idx, inst_idx):
    """(v (n, 3 corners, 3) world corners, vertex indices (n, 3)): the
    bits of `trace._light_tri_world`, each row of the instance transform a
    left-to-right dot product plus its translation, for all three corners
    in one pass."""
    m = _rows(scene.inst_tf, inst_idx)[:, None, :3, :]  # (n, 1, row, col)
    vidx = _rows(scene.tri_v, tri_idx).long()
    p = scene.pos[vidx][:, :, None, :]                   # (n, corner, 1, xyz)
    return (p[..., 0] * m[..., 0] + p[..., 1] * m[..., 1]
            + p[..., 2] * m[..., 2] + m[..., 3]), vidx


def _check_tables(scene, dev) -> None:
    T, I = scene.tri_v.shape[0], scene.inst_inv.shape[0]
    V, L = scene.pos.shape[0], scene.lights.shape[0]
    for name, dtype, shape in (
            ("tri_v", torch.int32, (T, 3)),
            ("tri_base_color", torch.float32, (T, 3)),
            ("tri_mat", torch.int32, (T,)),
            ("tri_mrir", torch.float32, (T, 3)),
            ("tri_tex", torch.int32, (T, 4)),
            ("tri_emissive", torch.float32, (T, 3)),
            ("pos", torch.float32, (V, 3)), ("nrm", torch.float32, (V, 3)),
            ("uv", torch.float32, (V, 2)),
            ("inst_tf", torch.float32, (I, 4, 4)),
            ("inst_inv", torch.float32, (I, 4, 4)),
            ("lights", torch.int32, (L, 2))):
        kernels.check(getattr(scene, name), name, dtype, shape, dev)
    if min(T, I, V, L) < 1 or scene.light_count > L:
        raise ValueError(f"scene: {T} triangles, {I} instances, {V} "
                         f"vertices, {L} light rows for "
                         f"{scene.light_count} lights")


def _texture_view(tex, dev) -> tuple[bool, int, int, int]:
    """(whether `tex` is a quad table, K, TH, TW), checked for the kernel."""
    if tex.is_floating_point():
        kernels.check(tex, "textures", torch.float32, (1, 1, 1, 3), dev)
        return False, 1, 1, 1
    kernels.check(tex, "textures", torch.int32, device=dev)
    if tex.dim() != 4 or tex.shape[3] != 4 or min(tex.shape) < 1:
        raise ValueError(f"textures: shape {tuple(tex.shape)}")
    if tex.data_ptr() % 16:
        raise ValueError("textures: rows must be 16-byte aligned")
    return (True, *tex.shape[:3])


def pack_shade(scene) -> ShadePack:
    """The kernel's records of `scene`, on its device, in plain torch with
    no host sync; `trace.scene_packs` builds it with the walks'
    `intersect.pack_walk`, once for a DeviceScene. On CUDA the tables are
    checked here, once, and the pack carries the kernel's view; `bvh_shade`
    then checks only the per-lane tensors."""
    dev = scene.tri_v.device
    if dev.type == "cuda":
        _check_tables(scene, dev)
    vidx = scene.tri_v.long()
    tris = _records(TRI_LAYOUT, {
        "p": scene.pos[vidx], "n": scene.nrm[vidx], "uv": scene.uv[vidx],
        "base_color": scene.tri_base_color, "mat": scene.tri_mat,
        "mrir": scene.tri_mrir, "tex": scene.tri_tex,
        "emissive": scene.tri_emissive})
    lref = scene.lights
    corners, lvidx = _world_corners(scene, lref[:, 1], lref[:, 0])
    lights = _records(LIGHT_LAYOUT, {
        "v": corners, "uv": scene.uv[lvidx],
        "base_color": _rows(scene.tri_base_color, lref[:, 1]),
        "tex": _rows(scene.tri_tex, lref[:, 1])[:, 0]})
    insts = _records(INST_LAYOUT, {
        "inst_inv": scene.inst_inv[:, :3], "inst_tf": scene.inst_tf[:, :3]})
    tex = scene.textures
    view, textured = None, not tex.is_floating_point()
    if dev.type == "cuda":
        textured, k, th, tw = _texture_view(tex, dev)
        if any(x.data_ptr() % 16 for x in (tris, lights, insts)):
            raise ValueError("pack: records must be 16-byte aligned")
        p = kernels.ptr
        view = _Scene(p(tris), p(lights), p(insts), p(tex), tris.shape[0],
                      insts.shape[0], int(scene.light_count), k, th, tw)
    return ShadePack(tris, lights, insts, tex, int(scene.light_count), view,
                     textured)


# The kernel's outputs (name, dtype, shape; None is R), in its order.
_OUTPUTS = (("state_out", torch.float32, (NS, None)),
            ("rng_out", torch.int64, (None,)),
            ("ro_next", torch.float32, (None, 3)),
            ("rd_next", torch.float32, (None, 3)),
            ("do_next", torch.bool, (None,)),
            ("sro", torch.float32, (None, 3)),
            ("srd", torch.float32, (None, 3)),
            ("s_tmax", torch.float32, (None,)),
            ("nee_lane", torch.bool, (None,)))


def shade_outputs(R: int, dev) -> tuple:
    """New (state (NS, R), rng (R,), Bounce) tensors for `bvh_shade`."""
    t = [torch.empty(tuple(R if k is None else k for k in shape),
                     dtype=dtype, device=dev) for _, dtype, shape in _OUTPUTS]
    return t[0], t[1], Bounce(*t[2:])


def bvh_shade(scene, state, rng, ro, rd, active, tri, inst, occluded,
              depth: int, max_depth: int, pack: ShadePack | None = None,
              out: tuple | None = None):
    """One bounce: (state (NS, R), rng (R,), Bounce). On the CPU
    `bvh_shade_step` (which reads `scene`'s tables; `pack` and `out` are not
    read); on CUDA the kernel over `pack` (`pack_shade(scene)` when not
    given; its textured instantiation when the textures are a quad table),
    which raises on a bad input. The kernel writes into `out`, an earlier
    call's (state, rng, Bounce) at the same lane count that no input
    aliases, or into new tensors."""
    if state.device.type == "cpu":
        return bvh_shade_step(scene, state, rng, ro, rd, active, tri, inst,
                              occluded, depth, max_depth)
    dev = state.device
    if pack is None:
        pack = pack_shade(scene)
    elif (pack.tris.shape[0], pack.lights.shape[0], pack.insts.shape[0],
          pack.light_count) != (scene.tri_v.shape[0], scene.lights.shape[0],
                                scene.inst_inv.shape[0],
                                int(scene.light_count)):
        raise ValueError("pack: not built from this scene (triangle, light "
                         "or instance counts differ)")
    if pack.view is None or pack.tris.device != dev:
        raise ValueError(f"pack: built on {pack.tris.device}, not on {dev}")
    R = ro.shape[0]
    kernels.check(state, "state", torch.float32, (NS, R), dev)
    kernels.check(rng, "rng", torch.int64, (R,), dev)
    kernels.check(ro, "ro", torch.float32, (R, 3), dev)
    kernels.check(rd, "rd", torch.float32, (R, 3), dev)
    kernels.check(tri, "tri", torch.int32, (R,), dev)
    kernels.check(inst, "inst", torch.int32, (R,), dev)
    for name, mask in (("active", active), ("occluded", occluded)):
        if mask is not None:
            kernels.check(mask, name, torch.bool, (R,), dev)

    if out is None:
        out = shade_outputs(R, dev)
    else:
        for t, (name, dtype, shape) in zip((out[0], out[1], *out[2]),
                                           _OUTPUTS):
            kernels.check(t, name, dtype, tuple(R if k is None else k
                                                for k in shape), dev)
    state_out, rng_out, nxt = out
    p = kernels.ptr
    with torch.cuda.device(dev):
        code = kernels.library().wrt_bvh_shade(
            ctypes.addressof(pack.view), int(pack.textured), p(state), p(rng),
            p(ro), p(rd), p(active), p(tri), p(inst), p(occluded), depth,
            max_depth, R, p(state_out), p(rng_out), *(p(t) for t in nxt),
            kernels.stream(dev))
    kernels.raise_on_error(code, "bvh_shade")
    kernels.launches["bvh_shade"] += 1
    return out
