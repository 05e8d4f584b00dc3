"""The BVH path's path tracer: camera rays, bounce loop, accumulation.

The port of the JAX package's `ops/trace.py`: per-pixel PCG streams,
thin-lens depth of field, pixel jitter, MIS between NEE and BSDF sampling
(power heuristic), any-hit shadow rays, the geometric-normal guard,
Russian roulette after depth 3, and sum + count accumulation. Rays are
(R, 3) tensors, as in the JAX package; every walk goes through
`ops/intersect.py` (`csrc/bvh_walk.cu` on the card, the plain walk on the
CPU). `trace_pixels` runs `ray_color_rows`: the bounce between the walks is
one `ops/bvh_shade.py` launch (`csrc/bvh_shade.cu` on the card, over the
scene's `ShadePack`, its plain `bvh_shade_step` on the CPU), where XLA
compiles `ray_color`'s loop body into one program. `ray_color`, the bounce
in plain PyTorch between the walks, stays as the reference the rows loop
equals bit for bit on the CPU.

Differences of mechanism, not of result:
- the last bounce runs no extension walk: its lanes may not continue
  (`depth < max_depth - 1` is false for all of them), so a frame of depth
  D >= 1 makes spp * D closest walks (the primary, then D - 1 extensions)
  and spp * D shadow walks;
- `sample_texture` samples unconditionally where JAX skips the gather when
  no lane carries a texture (`lax.cond`, a host sync here): both give white
  where tex_idx < 0;
- ray counts are summed in float64 on the device, with no sync a bounce.

At max_depth 0 the loop runs no bounce: zero radiance, R rays a sample
(the JAX BVH loop's `fori_loop(0, 0)`; the dense path runs one last
shadow-only bounce there instead, in both packages).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import bsdf
from .bsdf import PI, cross, dot, norm, normalize, power_heuristic
from .intersect import (instance_ray, intersect_closest, intersect_shadow,
                        pack_walk)
from .rng import frame_tensor, init_rng, rand_n, rand_pcg
from .v3 import sqrt_rn


def _offset_eps(p):
    """Scale-adaptive ray-origin offset (R,): 1e-4 * max(1, max |p|)."""
    return 1e-4 * torch.clamp(torch.abs(p).amax(dim=-1), min=1.0)


def _rows(table, idx):
    """table[clip(idx)] for per-triangle / per-instance tables."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


# ---------------------------------------------------------------------------
# Texture sampling: bilinear, repeat, level 0
# ---------------------------------------------------------------------------


def sample_texture(textures, tex_idx, uv):
    """Bilinear sample of the level-0 quad table (K, TH, TW, 4) int32:
    one row a sample holds the four corners as r<<16 | g<<8 | b codes.
    tex_idx < 0 gives white; the (1, 1, 1, 3) f32 placeholder gives its
    texel where tex_idx >= 0."""
    if textures.is_floating_point():
        texel = textures[0, 0, 0][None, :]
        return torch.where((tex_idx >= 0)[..., None], texel, 1.0)
    K, TH, TW, _ = textures.shape
    idx = tex_idx.clamp(0, K - 1)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    fx = u * TW - 0.5
    fy = v * TH - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    wx = fx - x0
    wy = fy - y0
    rows = (idx * TH + y0 % TH) * TW + x0 % TW
    q = textures.reshape(-1, 4)[rows.long()]

    def corner(c):
        w = q[..., c]
        return torch.stack([(w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF],
                           dim=-1).to(torch.float32) * (1.0 / 255.0)

    top = corner(0) * (1 - wx)[..., None] + corner(1) * wx[..., None]
    bot = corner(2) * (1 - wx)[..., None] + corner(3) * wx[..., None]
    rgb = top * (1 - wy)[..., None] + bot * wy[..., None]
    return torch.where((tex_idx >= 0)[..., None], rgb, 1.0)


# ---------------------------------------------------------------------------
# Hit shading data
# ---------------------------------------------------------------------------


class HitData(NamedTuple):
    hit_t: torch.Tensor        # (R,)
    tex_uv: torch.Tensor       # (R, 2)
    normal: torch.Tensor       # (R, 3) shading normal (world, normal-mapped)
    world_geom_n: torch.Tensor  # (R, 3)
    albedo: torch.Tensor       # (R, 3) base_color * base texture


def _inv_transpose_dir(inv, n):
    """normalize((vec4(n, 0) * inv).xyz): the inverse-transpose normal."""
    return normalize(torch.stack(
        [n[:, 0] * inv[:, 0, j] + n[:, 1] * inv[:, 1, j]
         + n[:, 2] * inv[:, 2, j] for j in range(3)], dim=-1))


def _verts(table, vidx):
    """The rows of a per-vertex table at a triangle's three vertices."""
    return table[vidx[:, 0]], table[vidx[:, 1]], table[vidx[:, 2]]


def load_hit(scene, ro, rd, tri_idx, inst_idx) -> HitData:
    """Barycentrics and attributes of a known (tri, inst) hit."""
    inv = _rows(scene.inst_inv, inst_idx)
    lro, lrd = instance_ray(inv, ro, rd)

    vidx = _rows(scene.tri_v, tri_idx).long()
    v0, v1, v2 = _verts(scene.pos, vidx)
    s = lro - v0
    e1 = v1 - v0
    e2 = v2 - v0
    h = cross(lrd, e2)
    f = 1.0 / dot(e1, h)
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(lrd, q)
    w = 1.0 - u - v
    hit_t = f * dot(e2, q)

    uv0, uv1, uv2 = _verts(scene.uv, vidx)
    tex_uv = uv0 * w[:, None] + uv1 * u[:, None] + uv2 * v[:, None]
    n0, n1, n2 = _verts(scene.nrm, vidx)
    ln = normalize(n0 * w[:, None] + n1 * u[:, None] + n2 * v[:, None])

    tex = _rows(scene.tri_tex, tri_idx)
    albedo = _rows(scene.tri_base_color, tri_idx) \
        * sample_texture(scene.textures, tex[:, 0], tex_uv)

    # Tangent-space normal mapping with the edge-1 tangent.
    normal_tex = tex[:, 2]
    n_map = sample_texture(scene.textures, normal_tex, tex_uv) * 2.0 - 1.0
    t_axis = normalize(e1)
    b_axis = normalize(cross(ln, t_axis))
    ln_mapped = normalize(t_axis * n_map[:, 0:1] + b_axis * n_map[:, 1:2]
                          + ln * n_map[:, 2:3])
    ln_final = torch.where((normal_tex >= 0)[:, None], ln_mapped, ln)
    normal = _inv_transpose_dir(inv, ln_final)
    world_geom_n = _inv_transpose_dir(inv, normalize(cross(e1, e2)))
    return HitData(hit_t, tex_uv, normal, world_geom_n, albedo)


# ---------------------------------------------------------------------------
# Next-event estimation
# ---------------------------------------------------------------------------


class LightSample(NamedTuple):
    L: torch.Tensor     # (R, 3)
    dir: torch.Tensor   # (R, 3)
    dist: torch.Tensor  # (R,)
    pdf: torch.Tensor   # (R,)


def _light_tri_world(scene, tri_idx, inst_idx):
    m = _rows(scene.inst_tf, inst_idx)
    vidx = _rows(scene.tri_v, tri_idx).long()

    def xf(p):
        return torch.stack([dot(m[:, i, :3], p) + m[:, i, 3]
                            for i in range(3)], dim=-1)

    v0, v1, v2 = (xf(p) for p in _verts(scene.pos, vidx))
    return v0, v1, v2, vidx


def sample_light_source(scene, hit_p, r0, r1, r2) -> LightSample:
    """Uniform light pick and a sqrt-warped area sample on it."""
    lc = int(scene.light_count)
    lc_f = float(max(lc, 1))
    pick = (r0 * lc_f).to(torch.int32).clamp(0, max(lc - 1, 0))
    lref = _rows(scene.lights, pick)
    v0, v1, v2, vidx = _light_tri_world(scene, lref[:, 1], lref[:, 0])

    sqrt_r1 = sqrt_rn(r1)
    u = 1.0 - sqrt_r1
    v = r2 * sqrt_r1
    w = 1.0 - u - v

    p = v0 * u[:, None] + v1 * v[:, None] + v2 * w[:, None]
    cr = cross(v1 - v0, v2 - v0)
    n_raw = normalize(cr)
    area = norm(cr) * 0.5

    l_dir = p - hit_p
    dist_sq = dot(l_dir, l_dir)
    dist = sqrt_rn(dist_sq)
    unit_l = l_dir / torch.clamp(dist, min=1e-20)[:, None]
    cos_theta_l = torch.clamp(dot(n_raw, -unit_l), min=0.0)

    uv0, uv1, uv2 = _verts(scene.uv, vidx)
    tex_uv = uv0 * u[:, None] + uv1 * v[:, None] + uv2 * w[:, None]
    tcl = lref[:, 1]
    L = _rows(scene.tri_base_color, tcl) * sample_texture(
        scene.textures, _rows(scene.tri_tex, tcl)[:, 0], tex_uv)

    pdf = dist_sq / torch.clamp(cos_theta_l * area, min=1e-20) / lc_f
    valid = (cos_theta_l >= 1e-6) & (area > 0.0) & (lc > 0)
    return LightSample(L, unit_l, dist, torch.where(valid, pdf, 0.0))


def get_light_pdf(scene, tri_idx, inst_idx, t, l_dir):
    """The pdf with which NEE would have sampled this emissive hit."""
    v0, v1, v2, _ = _light_tri_world(scene, tri_idx, inst_idx)
    cr = cross(v1 - v0, v2 - v0)
    area = norm(cr) * 0.5
    cos_theta_l = torch.clamp(dot(normalize(cr), -l_dir), min=0.0)
    lc_f = float(max(int(scene.light_count), 1))
    pdf = (t * t) / torch.clamp(cos_theta_l * area, min=1e-20) / lc_f
    return torch.where(cos_theta_l >= 1e-4, pdf, 0.0)


# ---------------------------------------------------------------------------
# The bounce loop
# ---------------------------------------------------------------------------


def _col(mask):
    return mask[:, None]


def ray_color(scene, ro, rd, rng, max_depth: int, pack=None):
    """Trace rays to completion: (radiance (R, 3), rng, rays), `rays` the
    exact float64 device count of rays traced (primaries, NEE shadow lanes
    and extension lanes actually walked). The plain reference of
    `ray_color_rows`: its bounce is torch ops between the walks. On the card
    the walks read `pack` (`intersect.pack_walk(scene)`)."""
    R = ro.shape[0]
    dev = ro.device
    primary = intersect_closest(scene, ro, rd, pack=pack)
    hd = load_hit(scene, ro, rd, primary.tri_idx, primary.inst_idx)
    active = primary.inst_idx >= 0
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    prev_pdf = torch.zeros(R, dtype=torch.float32, device=dev)
    specular_bounce = torch.ones(R, dtype=torch.bool, device=dev)
    tri, inst = primary.tri_idx, primary.inst_idx
    hit_t, tex_uv, s_normal, s_geom, albedo = hd
    rays = torch.full((), float(R), dtype=torch.float64, device=dev)

    for depth in range(max_depth):
        mat = _rows(scene.tri_mat, tri)
        mrir = _rows(scene.tri_mrir, tri)
        tex = _rows(scene.tri_tex, tri)
        emissive0 = _rows(scene.tri_emissive, tri)

        hit_p = ro + rd * hit_t[:, None]
        # Face the normals against the incoming ray.
        normal = torch.where(_col(dot(rd, s_normal) < 0.0), s_normal,
                             -s_normal)
        geom_n = torch.where(_col(dot(rd, s_geom) < 0.0), s_geom, -s_geom)

        mr = sample_texture(scene.textures, tex[:, 1], tex_uv)
        metallic = torch.where(tex[:, 1] >= 0, mrir[:, 0] * mr[:, 2],
                               mrir[:, 0])
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
            _col(active & has_em), throughput * em_val * mis_w[:, None], 0.0)
        active = active & ~is_light

        # NEE with a shadow ray.
        rng, (r0, r1, r2) = rand_n(rng, 3)
        ls = sample_light_source(scene, hit_p, r0, r1, r2)
        nee_lane = active & (mat != 2) & (ls.pdf > 0.0)
        eps = _offset_eps(hit_p)
        occluded = intersect_shadow(
            scene, hit_p + geom_n * eps[:, None], ls.dir,
            t_max=ls.dist - 2.0 * torch.maximum(
                eps, _offset_eps(hit_p + ls.dir * ls.dist[:, None])),
            active=nee_lane, pack=pack)
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
        take = nee_lane & ~occluded & (bsdf_pdf > 0.0)
        radiance = radiance + torch.where(_col(take), contrib, 0.0)

        # BSDF sampling.
        rng, (s1, s2) = rand_n(rng, 2)
        sc_d = bsdf.sample_diffuse(normal, albedo, s1, s2)
        sc_m = bsdf.sample_ggx(normal, -rd, roughness, f0, s1, s2)
        sc_g = bsdf.sample_dielectric(rd, normal, ior, albedo, s1)
        is_m = mat == 1
        is_g = mat == 2

        def pick(g, m, d):
            if g.dim() == 2:
                return torch.where(_col(is_g), g,
                                   torch.where(_col(is_m), m, d))
            return torch.where(is_g, g, torch.where(is_m, m, d))

        dirn = pick(sc_g.dir, sc_m.dir, sc_d.dir)
        pdf = pick(sc_g.pdf, sc_m.pdf, sc_d.pdf)
        tp = pick(sc_g.throughput, sc_m.throughput, sc_d.throughput)
        is_spec = pick(sc_g.is_specular, sc_m.is_specular, sc_d.is_specular)

        # Geometric-normal guard for non-dielectrics.
        bad = (mat != 2) & (dot(dirn, geom_n) <= 0.0)
        pdf = torch.where(bad, 0.0, pdf)
        tp = torch.where(_col(bad), 0.0, tp)

        active = active & (pdf > 0.0) & (norm(tp) > 0.0)
        throughput = torch.where(_col(active), throughput * tp, throughput)
        off_n = torch.where(_col(dot(dirn, geom_n) > 0.0), geom_n, -geom_n)
        new_ro = hit_p + off_n * eps[:, None]
        ro = torch.where(_col(active), new_ro, ro)
        rd = torch.where(_col(active), dirn, rd)
        prev_pdf = torch.where(active, pdf, prev_pdf)
        specular_bounce = torch.where(active, is_spec, specular_bounce)

        # Russian roulette after depth 3.
        rng, rr = rand_pcg(rng)
        p = throughput.amax(dim=-1)
        do_rr = active & (depth > 3)
        active = active & ~(do_rr & (rr > p))
        throughput = torch.where(
            _col(do_rr & (rr <= p)),
            throughput / torch.clamp(p, min=1e-20)[:, None], throughput)

        rays = rays + nee_lane.sum(dtype=torch.float64)
        if depth == max_depth - 1:
            break  # no lane may continue: the last bounce walks no more
        # Next intersection.
        nxt = intersect_closest(scene, ro, rd, active=active, pack=pack)
        found = active & (nxt.inst_idx >= 0)
        hdn = load_hit(scene, ro, rd, nxt.tri_idx, nxt.inst_idx)
        rays = rays + active.sum(dtype=torch.float64)
        tri = torch.where(found, nxt.tri_idx, tri)
        inst = torch.where(found, nxt.inst_idx, inst)
        hit_t = torch.where(found, hdn.hit_t, hit_t)
        tex_uv = torch.where(_col(found), hdn.tex_uv, tex_uv)
        s_normal = torch.where(_col(found), hdn.normal, normal)
        s_geom = torch.where(_col(found), hdn.world_geom_n, geom_n)
        albedo = torch.where(_col(found), hdn.albedo, albedo)
        active = found
    return radiance, rng, rays


def ray_color_rows(scene, ro, rd, rng, max_depth: int, pack=None,
                   shade_pack=None):
    """`ray_color` on a row state, one shade launch a bounce: the primary
    closest walk, then per bounce one `bvh_shade` (`csrc/bvh_shade.cu` on
    the card, `bvh_shade_step` on the CPU), one any-hit walk over its
    shadow rays and, but after the last bounce, one closest walk over its
    extension rays; a last fold adds the last bounce's NEE where its
    shadow walk found nothing. Equal to `ray_color` bit for bit on the
    CPU: (radiance (R, 3), rng, rays), rays summed in float64 on the
    device. At max_depth 0 no walk runs: zero radiance, R rays. On the
    card the walks read `pack` (`intersect.pack_walk(scene)`) and every
    shade `shade_pack` (`bvh_shade.pack_shade(scene)`)."""
    # Imported here: ops/bvh_shade.py builds on this module's functions.
    from .bvh_shade import RAYS, bvh_shade, initial_state, resolve

    R = ro.shape[0]
    dev = ro.device
    rays = torch.full((), float(R), dtype=torch.float64, device=dev)
    if max_depth <= 0:
        return torch.zeros((R, 3), dtype=torch.float32, device=dev), rng, rays
    hit = intersect_closest(scene, ro, rd, pack=pack)
    state = initial_state(R, dev)
    active = occluded = None
    # Two sets of shade outputs in turn: a bounce writes the set its inputs
    # did not come from, which the bounce before last filled.
    outs = [None, None]
    for depth in range(max_depth):
        state, rng, nxt = outs[depth % 2] = bvh_shade(
            scene, state, rng, ro, rd, active, hit.tri_idx, hit.inst_idx,
            occluded, depth, max_depth, shade_pack, outs[depth % 2])
        occluded = intersect_shadow(scene, nxt.sro, nxt.srd, t_max=nxt.s_tmax,
                                    active=nxt.nee_lane, pack=pack)
        if depth == max_depth - 1:
            break  # no lane may continue: the last bounce walks no more
        ro, rd, active = nxt.ro, nxt.rd, nxt.do_next
        hit = intersect_closest(scene, ro, rd, active=active, pack=pack)
    rays = rays + state[RAYS].sum(dtype=torch.float64)
    return resolve(state, occluded).T, rng, rays


# ---------------------------------------------------------------------------
# Per-frame entry: camera rays, the spp loop
# ---------------------------------------------------------------------------


def camera_unpack(camera24):
    return dict(origin=camera24[0:3], lens_radius=camera24[3],
                lower_left=camera24[4:7], horizontal=camera24[8:11],
                vertical=camera24[12:15], u_axis=camera24[16:19],
                v_axis=camera24[20:23])


# scene.tri_v -> (weak references to the scene's tensors, each field's
# `_version` or value, (WalkPack, ShadePack)). The entry goes when tri_v
# does, so the packs live as long as their scene; of its tables they hold
# only the texture one.
_packs = WeakIdKeyDictionary()


def scene_packs(scene):
    """(WalkPack, ShadePack) of a DeviceScene: built at its first
    `trace_pixels` call on the card and reused while the scene holds the
    same tensors, none written in place since (their `_version`), so a
    frame of a 257k-triangle scene does not rebuild 50 MB of records. An
    edited scene, in place or by `_replace`, gets fresh packs. Plain torch,
    on the scene's device."""
    is_t = [isinstance(f, torch.Tensor) for f in scene]
    key = [f._version if t else f for f, t in zip(scene, is_t)]
    entry = _packs.get(scene.tri_v)
    if entry is not None and entry[1] == key and all(
            r() is f for r, f in zip(entry[0], scene) if r is not None):
        return entry[2]
    # Imported here: ops/bvh_shade.py builds on this module's functions.
    from .bvh_shade import pack_shade

    packs = (pack_walk(scene), pack_shade(scene))
    _packs[scene.tri_v] = ([weakref.ref(f) if t else None
                            for f, t in zip(scene, is_t)], key, packs)
    return packs


def trace_pixels(scene, camera24, frame_count, jitter, width: int,
                 height: int, spp: int, max_depth: int, row0: int = 0,
                 full_height: int | None = None,
                 total_spp: int | None = None, sample0: int = 0,
                 with_stats: bool = False):
    """One frame's radiance, (H*W, 3) averaged over spp; with with_stats,
    (radiance, rays) with the exact float64 device ray count. Each sample
    runs `ray_color_rows`; on the card its walks and shades read the
    scene's packs (`scene_packs`).

    row0 / full_height: this call renders rows [row0, row0 + height) of a
    full_height-tall frame with the frame's pixel indices and jitter (tile
    sharding). sample0 / total_spp: samples [sample0, sample0 + spp) of a
    total_spp-sample frame with the frame's RNG streams (sample
    sharding). `frame_count` is an int or a 0-d int64 tensor on the
    camera's device, whose seeds are then computed on the device (a
    captured frame step replays with the count it reads there)."""
    if full_height is None:
        full_height = height
    if total_spp is None:
        total_spp = spp
    cam = camera_unpack(camera24)
    dev = camera24.device
    R = width * height
    pack, shade_pack = (scene_packs(scene) if dev.type == "cuda"
                        else (None, None))
    lane = torch.arange(R, dtype=torch.int64, device=dev)
    gx = lane % width
    gy = lane // width + row0
    px = gx.to(torch.float32)
    py = gy.to(torch.float32)
    p_idx = gy * width + gx

    acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(spp):
        rng = init_rng(p_idx, frame_count * total_spp + sample0 + i)
        # Thin-lens offset; always two draws, so the stream does not
        # depend on the scene.
        rng, (dr1, dr2) = rand_n(rng, 2)
        dx, dy = bsdf.random_in_unit_disk(dr1, dr2)
        rdx = cam["lens_radius"] * dx
        rdy = cam["lens_radius"] * dy
        off = cam["u_axis"][None, :] * rdx[:, None] \
            + cam["v_axis"][None, :] * rdy[:, None]
        u = (px + 0.5 + jitter[0] * width) / width
        v = 1.0 - (py + 0.5 + jitter[1] * full_height) / full_height
        d = (cam["lower_left"][None, :] + u[:, None] * cam["horizontal"][None]
             + v[:, None] * cam["vertical"][None] - cam["origin"][None]
             - off)
        ro = cam["origin"][None, :] + off
        col, _, r = ray_color_rows(scene, ro, d, rng, max_depth, pack,
                                   shade_pack)
        acc = acc + col
        rays = rays + r
    col = acc / spp
    return (col, rays) if with_stats else col


def accumulate(prev_acc: torch.Tensor, col: torch.Tensor,
               frame_count) -> torch.Tensor:
    """Sum + count accumulation into `prev_acc` (R, 4), which is written and
    returned: the JAX package's donated accumulator. The reset is semantic,
    a select on the device as in the JAX package: frame 1 overwrites, so a
    stale buffer never contributes. `frame_count` is an int or a 0-d int64
    tensor on the accumulator's device."""
    sample = torch.cat([col, torch.ones_like(col[:, :1])], dim=-1)
    return torch.where(frame_tensor(frame_count, prev_acc.device) > 1,
                       prev_acc + sample, sample, out=prev_acc)

