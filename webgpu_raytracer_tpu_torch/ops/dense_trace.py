"""Path tracing over the dense world-triangle sweep: the port's main paths.

The port of the JAX package's `ops/dense_trace.py`:

- `trace_pixels_dense`: one progressive frame over the whole image
  (unbanded), with the thin-lens ray generation of `_trace_lanes`, traced
  primaries or bounce 0 seeded from a G-buffer id channel (`seed_wt_idx`);
- `ray_color_dense_rows`: the row-state bounce loop, one CUDA shade launch
  and one fused 2R-lane sweep a bounce, for every scene at `max_depth`
  > 0: untextured scenes through the shade kernel's white-texel
  instantiation, textured ones through its textured instantiation, which
  samples the (level0, level1) quad-table pyramid inside the kernel;
- `ray_color_dense`: the per-ray pipeline of plain torch ops between the
  kernels, with texture sampling: hits rebuilt from the winner's shade row
  (`shade_from_rowT`), light rows through the row fetch kernel and texels
  through the quad fetch kernel (`ops/cuda_fetch.py`). It serves
  `max_depth` 0 (one shadow-only last bounce) and is the textured
  reference the tests hold the row-state loop to; its `intersect_and_shade`
  shades the G-buffer pass (`ops/gbuffer.py`).

Every sweep takes the caller's `narrow` ("jobs", the default, or "scan"),
threaded explicitly from `Renderer` down as the JAX package threads its
`tune`: the narrow phase of a multi-tile scene (`ops/cuda_dense.py`). Both
give the same hits bit for bit; a single-tile scene ignores it.

Both loops use the same estimator and the same RNG streams as the JAX
package. Differences of mechanism, not of result:
- every one of `max_depth` bounces runs; there is no host sync for JAX's
  `lax.cond(any_live)` skip. A bounce over all-dead lanes adds zero. At
  `max_depth` 0 the JAX loop still runs its last, shadow-only bounce (at
  depth -1), and so does the port, through `ray_color_dense` on every
  scene;
- JAX shades textured scenes with its per-ray loop (its shade kernel
  cannot gather texels on the TPU); the port's row-state loop samples them
  as that loop does, and the two give the same frame on the CPU bit for
  bit;
- where JAX skips a texture sample when no lane carries that map
  (`lax.cond(jnp.any(...))`), `ray_color_dense` skips the slots that no
  triangle of the scene binds (`WorldTables.tex_slots` / `light_tex`, host
  facts from the tables) and samples the rest unconditionally, so its
  launch counts are fixed per frame; `shade_step` skips as JAX does, and
  the shade kernel reads a texel quad only for a lane whose slot index is
  >= 0: the same result;
- the exact ray count is reduced on the device, with no per-bounce sync;
- the band and tail-compaction knobs of the TPU path are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import bsdf_v3 as bsdf
from .bsdf_v3 import PI, power_heuristic
from .cuda_dense import closest_with_row, shadow
from .cuda_fetch import fetch_rows_t
from .dense import T_MAX, ray_stack
# The sampler lives in ops/fetch.py; its names are re-exported here.
from .fetch import sample_texture_v3, tex_level, texel_rows  # noqa: F401
from .rng import init_rng, rand_n, rand_pcg
from .shade_rows import (BASE, EMISSIVE, METAL_ROUGH, NORMAL, _offset_eps,
                         shade)
from .v3 import (V3, cross, dot, length, max_component, normalize, sqrt_rn,
                 where)
from ..render.worldtris import SHADE_COLS, WorldTables


def _row_v3(rowT, name) -> V3:
    lo = SHADE_COLS[name][0]
    return V3(rowT[lo], rowT[lo + 1], rowT[lo + 2])


def _row_f(rowT, name, k=0):
    return rowT[SHADE_COLS[name][0] + k]


# Every texture slot bound: `shade_from_rowT`'s default.
ALL_SLOTS = (True, True, True, True)


class DenseHit(NamedTuple):
    """A bounce's hits. The row-state loop reads only rowT and wt, so a
    seed for it may carry just those."""

    rowT: torch.Tensor  # (SHADE_K, R) shade rows of the hit tris
    wt: torch.Tensor    # (R,) int32 world-tri index (-1 = miss)
    hit_t: Optional[torch.Tensor] = None
    tex_u: Optional[torch.Tensor] = None
    tex_v: Optional[torch.Tensor] = None
    normal: Optional[V3] = None  # shading normal (normal-mapped, world)
    geom_n: Optional[V3] = None
    albedo: Optional[V3] = None


def shade_from_rowT(textures, rowT, ro: V3, rd: V3, valid=None,
                    level: int = 0, slots: tuple = ALL_SLOTS):
    """Barycentric attributes for a known world triangle (world space).

    `valid` masks lanes with no real row (miss lanes carry zeroed rows,
    whose texture slots would read as texture 0). `slots` names the
    texture slots some triangle binds; the others sample as white."""
    v0 = _row_v3(rowT, "v0")
    e1 = _row_v3(rowT, "e1")
    e2 = _row_v3(rowT, "e2")

    s = ro - v0
    h = cross(rd, e2)
    a = dot(e1, h)
    f = 1.0 / torch.where(torch.abs(a) > 1e-20, a, 1e-20)
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(rd, q)
    w = 1.0 - u - v

    lo0 = SHADE_COLS["uv0"][0]
    lo1 = SHADE_COLS["uv1"][0]
    lo2 = SHADE_COLS["uv2"][0]
    tex_u = rowT[lo0] * w + rowT[lo1] * u + rowT[lo2] * v
    tex_v = rowT[lo0 + 1] * w + rowT[lo1 + 1] * u + rowT[lo2 + 1] * v

    ln = normalize(_row_v3(rowT, "n0") * w + _row_v3(rowT, "n1") * u
                   + _row_v3(rowT, "n2") * v)

    base_tex = _row_f(rowT, "tex", 0).to(torch.int32)
    normal_tex = _row_f(rowT, "tex", 2).to(torch.int32)
    if valid is not None:
        base_tex = torch.where(valid, base_tex, -1)
        normal_tex = torch.where(valid, normal_tex, -1)
    tex = tex_level(textures, level)
    albedo = _row_v3(rowT, "base_color") * sample_texture_v3(
        tex if slots[BASE] else None, base_tex, tex_u, tex_v)

    normal = ln
    if slots[NORMAL]:
        # Tangent-space normal mapping with the edge-1 tangent.
        n_map = sample_texture_v3(tex, normal_tex, tex_u, tex_v) * 2.0 - 1.0
        t_axis = normalize(e1)
        b_axis = normalize(cross(ln, t_axis))
        ln_mapped = normalize(t_axis * n_map.x + b_axis * n_map.y
                              + ln * n_map.z)
        normal = where(normal_tex >= 0, ln_mapped, ln)

    geom_n = normalize(cross(e1, e2))
    return tex_u, tex_v, normal, geom_n, albedo


def _mt_refine_t(rowT, ro: V3, rd: V3):
    """f32 Moller-Trumbore hit distance for a KNOWN triangle row: the
    distance used for hit positions, re-derived from the winner row, which
    also makes G-buffer-seeded bounce 0 bit-identical to the traced one."""
    v0 = _row_v3(rowT, "v0")
    e1 = _row_v3(rowT, "e1")
    e2 = _row_v3(rowT, "e2")
    s = ro - v0
    h = cross(rd, e2)
    a = dot(e1, h)
    f = 1.0 / torch.where(torch.abs(a) > 1e-20, a, 1e-20)
    q = cross(s, e1)
    return f * dot(e2, q)


def intersect_and_shade(tables: WorldTables, textures, ro: V3, rd: V3,
                        active=None, level: int = 0,
                        narrow: str = "jobs") -> DenseHit:
    """Closest hit (one sweep launch) and its shading attributes. `active`
    None means every lane."""
    t_max = T_MAX if active is None else torch.where(active, T_MAX, 0.0)
    t, idx, rowT = closest_with_row(tables, ray_stack(ro, rd, t_max),
                                    narrow=narrow)
    t = torch.where(idx >= 0, _mt_refine_t(rowT, ro, rd), t)
    tex_u, tex_v, normal, geom_n, albedo = shade_from_rowT(
        textures, rowT, ro, rd, valid=idx >= 0, level=level,
        slots=tables.tex_slots)
    return DenseHit(rowT, idx, t, tex_u, tex_v, normal, geom_n, albedo)


def _fetch_rowT(table, idx):
    """(K, R) rows of `table` by index, clipped: the row fetch kernel on the
    card (the JAX package's one-hot fetch), its plain version on the CPU."""
    return fetch_rows_t(table, idx)


def seed_rows_from_wt_idx(tables: WorldTables, wt_idx) -> DenseHit:
    """A bounce-0 seed of winner rows only: what the row-state loop reads."""
    idx = wt_idx.to(torch.int32)
    rowT = _fetch_rowT(tables.shade_table, idx)
    return DenseHit(torch.where((idx >= 0)[None, :], rowT, 0.0), idx)


def seed_hit_from_wt_idx(tables: WorldTables, textures, wt_idx, ro: V3,
                         rd: V3) -> DenseHit:
    """Bounce-0 hit reconstructed from a G-buffer id channel: one shade-row
    fetch by world-tri row plus the shared shade_from_rowT / _mt_refine_t
    math, which gives radiance bit-identical to the traced-primary path
    (the traced path derives everything from the same rows)."""
    rowT, idx = seed_rows_from_wt_idx(tables, wt_idx)[:2]
    t = torch.where(idx >= 0, _mt_refine_t(rowT, ro, rd), T_MAX)
    tex_u, tex_v, normal, geom_n, albedo = shade_from_rowT(
        textures, rowT, ro, rd, valid=idx >= 0, slots=tables.tex_slots)
    return DenseHit(rowT, idx, t, tex_u, tex_v, normal, geom_n, albedo)


def sample_light_dense(tables: WorldTables, textures, hit_p: V3, r0, r1, r2):
    """NEE light sample over the world-tri lights: (L, unit_l, dist, pdf).
    One row fetch of the picked light rows."""
    lc = tables.light_count
    lc_f = float(max(lc, 1))
    pick = torch.clamp((r0 * lc_f).to(torch.int32), 0, max(lc - 1, 0))
    rowT = _fetch_rowT(tables.light_rows, pick)

    v0 = _row_v3(rowT, "v0")
    e1 = _row_v3(rowT, "e1")
    e2 = _row_v3(rowT, "e2")

    sqrt_r1 = sqrt_rn(r1)
    u = 1.0 - sqrt_r1
    v = r2 * sqrt_r1
    w = 1.0 - u - v
    # p = v0*u + v1*v + v2*w with v1 = v0+e1, v2 = v0+e2
    p = v0 + e1 * v + e2 * w

    cr = cross(e1, e2)
    n_raw = normalize(cr)
    area = length(cr) * 0.5

    l_dir = p - hit_p
    dist_sq = dot(l_dir, l_dir)
    dist = sqrt_rn(dist_sq)
    unit_l = l_dir * (1.0 / torch.clamp(dist, min=1e-20))
    cos_theta_l = torch.clamp(dot(n_raw, -unit_l), min=0.0)

    lo0 = SHADE_COLS["uv0"][0]
    lo1 = SHADE_COLS["uv1"][0]
    lo2 = SHADE_COLS["uv2"][0]
    tex_u = rowT[lo0] * u + rowT[lo1] * v + rowT[lo2] * w
    tex_v = rowT[lo0 + 1] * u + rowT[lo1 + 1] * v + rowT[lo2 + 1] * w
    base_tex = _row_f(rowT, "tex", 0).to(torch.int32)
    L = _row_v3(rowT, "base_color") * sample_texture_v3(
        tex_level(textures, 1) if tables.light_tex else None, base_tex,
        tex_u, tex_v)

    pdf = dist_sq / torch.clamp(cos_theta_l * area, min=1e-20) / lc_f
    valid = (cos_theta_l >= 1e-6) & (area > 0.0) & (lc > 0)
    pdf = torch.where(valid, pdf, 0.0)
    return L, unit_l, dist, pdf


def light_pdf_from_rowT(tables: WorldTables, rowT, t, l_dir: V3):
    """MIS pdf of the emissive triangle just hit."""
    cr = cross(_row_v3(rowT, "e1"), _row_v3(rowT, "e2"))
    area = length(cr) * 0.5
    n = normalize(cr)
    cos_theta_l = torch.clamp(dot(n, -l_dir), min=0.0)
    lc_f = float(max(tables.light_count, 1))
    pdf = (t * t) / torch.clamp(cos_theta_l * area, min=1e-20) / lc_f
    return torch.where(cos_theta_l >= 1e-4, pdf, 0.0)


def shadow_query(tables: WorldTables, ro: V3, rd: V3, t_max, active,
                 narrow: str = "jobs"):
    """Any-hit occlusion of R lanes (one sweep launch): bool (R,)."""
    return shadow(tables, ray_stack(ro, rd, torch.where(active, t_max, 0.0)),
                  narrow=narrow)


def fused_shadow_and_next(tables: WorldTables, textures, sro: V3, srd: V3,
                          s_tmax, s_active, cro: V3, crd: V3, c_active,
                          narrow: str = "jobs"):
    """One sweep launch for both per-bounce ray sets: the NEE shadow rays
    (lanes [0, R)) and the extension rays (lanes [R, 2R)), with winner rows
    for the extension lanes only. Occlusion is `closest hit exists`.

    Returns (occluded (R,), DenseHit of the extension rays, level 1)."""
    R = sro.x.shape[0]
    rays8 = torch.empty((8, 2 * R), dtype=torch.float32, device=sro.x.device)
    for k, (a, b) in enumerate(zip((*srd, *sro), (*crd, *cro))):
        rays8[k, :R] = a
        rays8[k, R:] = b
    rays8[6, :R] = torch.where(s_active, s_tmax, 0.0)
    rays8[6, R:] = torch.where(c_active, T_MAX, 0.0)
    rays8[7] = 0.0
    t, idx, rowT = closest_with_row(tables, rays8, row_from_lane=R,
                                    narrow=narrow)
    occluded = idx[:R] >= 0
    nt, nidx = t[R:], idx[R:]
    nt = torch.where(nidx >= 0, _mt_refine_t(rowT, cro, crd), nt)
    tex_u, tex_v, normal, geom_n, albedo = shade_from_rowT(
        textures, rowT, cro, crd, valid=nidx >= 0, level=1,
        slots=tables.tex_slots)
    return occluded, DenseHit(rowT, nidx, nt, tex_u, tex_v, normal, geom_n,
                              albedo)


def ray_color_dense(tables: WorldTables, textures, ro: V3, rd: V3,
                    rng: torch.Tensor, max_depth: int,
                    hit0: Optional[DenseHit] = None, narrow: str = "jobs"):
    """Returns (radiance V3, rng, rays): `rays` is a float64 device scalar,
    the EXACT count of rays traced (primaries unless seeded, plus per
    bounce the NEE shadow lanes and the extension lanes actually swept).

    `hit0` seeds bounce 0 from a G-buffer (seed_hit_from_wt_idx) instead of
    tracing primaries. max_depth 0 runs the last bounce alone, at depth -1,
    as the JAX package does. Launches a frame, with D = max(max_depth, 1):
    1 + D sweeps traced (D seeded), D light-row fetches, and one quad fetch
    per bound texture slot per sample point (see chip_smoke.py)."""
    R = ro.x.shape[0]
    dev = ro.x.device
    f32 = torch.float32
    ones = torch.ones(R, dtype=f32, device=dev)
    zeros = torch.zeros(R, dtype=f32, device=dev)
    slots = tables.tex_slots

    primary = 0.0 if hit0 is not None else float(R)
    if hit0 is None:
        hit0 = intersect_and_shade(tables, textures, ro, rd, narrow=narrow)
    active = hit0.wt >= 0
    hit = hit0
    throughput = V3(ones, ones, ones)
    radiance = V3(zeros, zeros, zeros)
    prev_pdf = zeros
    specular_bounce = torch.ones(R, dtype=torch.bool, device=dev)
    rays = torch.full((), primary, dtype=torch.float64, device=dev)
    tex1 = tex_level(textures, 1)

    # At max_depth 0 the JAX loop still runs its last bounce, at depth -1.
    for depth in range(max_depth) if max_depth > 0 else (-1,):
        last = depth == max_depth - 1
        rowT = hit.rowT
        mat = _row_f(rowT, "mat").to(torch.int32)
        hit_p = ro + rd * hit.hit_t

        # Face normals against the incoming ray.
        normal = where(dot(rd, hit.normal) < 0.0, hit.normal, -hit.normal)
        geom_n = where(dot(rd, hit.geom_n) < 0.0, hit.geom_n, -hit.geom_n)

        metallic = _row_f(rowT, "mrir", 0)
        roughness = _row_f(rowT, "mrir", 1)
        if slots[METAL_ROUGH]:
            tex_mr = torch.where(active, _row_f(rowT, "tex", 1), -1.0) \
                .to(torch.int32)
            mr = sample_texture_v3(tex1, tex_mr, hit.tex_u, hit.tex_v)
            metallic = torch.where(tex_mr >= 0, metallic * mr.z, metallic)
            roughness = torch.where(tex_mr >= 0, roughness * mr.y, roughness)
        roughness = torch.clamp(roughness, min=0.005)
        ior = _row_f(rowT, "mrir", 2)

        emissive = _row_v3(rowT, "emissive")
        if slots[EMISSIVE]:
            tex_em = torch.where(active, _row_f(rowT, "tex", 3), -1.0) \
                .to(torch.int32)
            emissive = emissive * where(
                tex_em >= 0,
                sample_texture_v3(tex1, tex_em, hit.tex_u, hit.tex_v),
                V3(ones, ones, ones))

        albedo = hit.albedo
        f0 = albedo * metallic + (0.04 * (1.0 - metallic))

        # --- emissive / light hit with MIS ---
        is_light = mat == 3
        has_em = is_light | (length(emissive) > 1e-4)
        em_val = where(is_light, albedo, emissive)
        lp = light_pdf_from_rowT(tables, rowT, hit.hit_t, rd)
        mis_w = torch.where(specular_bounce, 1.0,
                            power_heuristic(prev_pdf, lp))
        add = torch.where(active & has_em, mis_w, 0.0)
        radiance = radiance + throughput * em_val * add
        active = active & ~is_light

        # --- NEE sample + BSDF response (the shadow query rides the sweep
        # below) ---
        rng, (r0, r1, r2) = rand_n(rng, 3)
        L, ldir, ldist, lpdf = sample_light_dense(tables, textures, hit_p,
                                                  r0, r1, r2)
        nee_lane = active & (mat != 2) & (lpdf > 0.0)
        eps = _offset_eps(hit_p)
        end_eps = torch.maximum(eps, _offset_eps(hit_p + ldir * ldist))
        n_dot_l = torch.clamp(dot(normal, ldir), min=0.0)
        is_diff = mat == 0
        bsdf_val = where(is_diff, bsdf.eval_diffuse(albedo),
                         bsdf.eval_ggx(normal, -rd, ldir, roughness, f0))
        bsdf_pdf = torch.where(is_diff, n_dot_l / PI,
                               bsdf.ggx_pdf(normal, -rd, ldir, roughness))
        nee_tp = throughput  # the contribution uses pre-scatter throughput

        # --- BSDF sampling ---
        rng, (s1, s2) = rand_n(rng, 2)
        sc_d = bsdf.sample_diffuse(normal, albedo, s1, s2)
        sc_m = bsdf.sample_ggx(normal, -rd, roughness, f0, s1, s2)
        sc_g = bsdf.sample_dielectric(rd, normal, ior, albedo, s1)
        is_m = mat == 1
        is_g = mat == 2
        dirn = where(is_g, sc_g.dir, where(is_m, sc_m.dir, sc_d.dir))
        pdf = torch.where(is_g, sc_g.pdf,
                          torch.where(is_m, sc_m.pdf, sc_d.pdf))
        tp = where(is_g, sc_g.throughput,
                   where(is_m, sc_m.throughput, sc_d.throughput))
        is_spec = torch.where(is_g, sc_g.is_specular,
                              torch.where(is_m, sc_m.is_specular,
                                          sc_d.is_specular))

        # Geometric-normal guard for non-dielectrics.
        bad = (mat != 2) & (dot(dirn, geom_n) <= 0.0)
        pdf = torch.where(bad, 0.0, pdf)
        tp = tp * torch.where(bad, 0.0, 1.0)

        active = active & (pdf > 0.0) & (length(tp) > 0.0)
        throughput = where(active, throughput * tp, throughput)
        off_n = where(dot(dirn, geom_n) > 0.0, geom_n, -geom_n)
        ro = where(active, hit_p + off_n * eps, ro)
        rd = where(active, dirn, rd)
        prev_pdf = torch.where(active, pdf, prev_pdf)
        specular_bounce = torch.where(active, is_spec, specular_bounce)

        # --- Russian roulette after depth 3 ---
        rng, rr = rand_pcg(rng)
        p = max_component(throughput)
        do_rr = active & (depth > 3)
        active = active & ~(do_rr & (rr > p))
        scale = torch.where(do_rr & (rr <= p),
                            1.0 / torch.clamp(p, min=1e-20), 1.0)
        throughput = throughput * scale

        # --- shadow + next hit: one fused 2R sweep, or on the last bounce
        # an R-lane shadow-only query ---
        sro = hit_p + geom_n * eps
        s_tmax = ldist - 2.0 * end_eps
        if last:
            occluded = shadow_query(tables, sro, ldir, s_tmax, nee_lane,
                                    narrow)
            do_next = torch.zeros_like(active)
        else:
            do_next = active
            occluded, hit = fused_shadow_and_next(
                tables, textures, sro, ldir, s_tmax, nee_lane, ro, rd,
                do_next, narrow)
        take = nee_lane & ~occluded & (bsdf_pdf > 0.0)
        wgt = torch.where(
            take,
            power_heuristic(lpdf, bsdf_pdf) * n_dot_l
            / torch.clamp(lpdf, min=1e-20), 0.0)
        radiance = radiance + nee_tp * bsdf_val * L * wgt
        rays = rays + nee_lane.sum(dtype=torch.float64) \
            + do_next.sum(dtype=torch.float64)
        if not last:
            # Lanes not found are inactive from here on and every later
            # contribution is active-gated, so they may carry the zero rows
            # of a miss; only hit_t is cleared (T_MAX squared overflows f32
            # in the NEE distance terms).
            active = do_next & (hit.wt >= 0)
            hit = hit._replace(hit_t=torch.where(active, hit.hit_t, 0.0))
    return radiance, rng, rays


def _initial_state(ro: V3, rd: V3) -> torch.Tensor:
    """The row-state loop's (20, R) state entering bounce 0."""
    R = ro.x.shape[0]
    zeros = torch.zeros(R, dtype=torch.float32, device=ro.x.device)
    ones = torch.ones(R, dtype=torch.float32, device=ro.x.device)
    return torch.stack([
        ones,                                   # 0  active
        ro.x, ro.y, ro.z, rd.x, rd.y, rd.z,     # 1-6 ray
        ones, ones, ones,                       # 7-9 throughput
        zeros, zeros, zeros,                    # 10-12 radiance
        zeros,                                  # 13 prev_pdf
        ones,                                   # 14 specular_bounce
        zeros,                                  # 15 nee_prev
        zeros, zeros, zeros,                    # 16-18 pending_nee
        ones,                                   # 19 occluded_prev
    ])


def _sweep_bounce(tables: WorldTables, out, rays8, R: int,
                  narrow: str = "jobs"):
    """Sweep a bounce's fused (8, 2R) stack: the next (state, idx, rowT)."""
    _, idx2, rowT = closest_with_row(tables, rays8, row_from_lane=R,
                                     narrow=narrow)
    # Rows 19-26 (the rays just swept) are spent: row 19 becomes the next
    # bounce's occluded_prev in place, and rows 0-19 its state.
    out[19] = (idx2[:R] >= 0).to(torch.float32)
    return out[:20], idx2[R:], rowT


def pinhole_rays(camera24: torch.Tensor, width: int, height: int):
    """Pixel-center rays (ro, rd) as V3 on the camera's device: no lens and
    no jitter."""
    lane = torch.arange(width * height, device=camera24.device)
    u = ((lane % width).float() + 0.5) / width
    v = 1.0 - ((lane // width).float() + 0.5) / height
    c = camera24
    rd = V3(*(c[4 + k] + u * c[8 + k] + v * c[12 + k] - c[k]
              for k in range(3)))
    ro = V3(*(c[k].expand(width * height).contiguous() for k in range(3)))
    return ro, rd


def bounce_inputs(tables: WorldTables, camera24: torch.Tensor, width: int,
                  height: int, depth: int, max_depth: int, textures=None):
    """(state, rng, rowT, idx) entering bounce `depth` of the row-state
    loop, from `pinhole_rays` and frame 1's rng streams: the inputs at
    which the tests and `chip_smoke.py` hold the sweeps and the shade
    kernel. `textures`: the scene's pyramid, or None (white texel)."""
    R = width * height
    ro, rd = pinhole_rays(camera24, width, height)
    rng = init_rng(torch.arange(R, device=tables.device), 1)
    _, idx, rowT = closest_with_row(tables, ray_stack(ro, rd, T_MAX))
    state = _initial_state(ro, rd)
    for d in range(depth):
        out, rng, rays8 = shade(state, rng, rowT, idx, tables.light_rows, d,
                                tables.light_count, max_depth, textures)
        state, idx, rowT = _sweep_bounce(tables, out, rays8, R)
    return state, rng, rowT, idx


def bounce_rays(tables: WorldTables, camera24: torch.Tensor, width: int,
                height: int, depth: int, max_depth: int,
                textures=None) -> torch.Tensor:
    """The fused (8, 2R) ray stack that bounce `depth` sweeps (its R NEE
    shadow rays, then its R extension rays)."""
    state, rng, rowT, idx = bounce_inputs(tables, camera24, width, height,
                                          depth, max_depth, textures)
    return shade(state, rng, rowT, idx, tables.light_rows, depth,
                 tables.light_count, max_depth, textures)[2]


def ray_color_dense_rows(tables: WorldTables, ro: V3, rd: V3,
                         rng: torch.Tensor, max_depth: int,
                         hit0: Optional[DenseHit] = None,
                         narrow: str = "jobs", textures=None):
    """Row-state bounce loop: one shade launch and one fused 2R-lane sweep
    a bounce, estimator-identical to ray_color_dense at max_depth > 0.
    `textures` is the scene's (level0, level1) pyramid, or None for the
    1x1 white texel. `hit0` (only its rowT and wt are read) seeds bounce 0
    from a G-buffer instead of tracing primaries.

    Returns (radiance V3, rng, rays): `rays` is a float64 device scalar,
    the EXACT count of rays traced: the R primaries unless seeded, plus, per
    bounce, the NEE shadow lanes and the extension lanes actually swept."""
    R = ro.x.shape[0]
    if hit0 is None:
        _, idx, rowT = closest_with_row(tables, ray_stack(ro, rd, T_MAX),
                                        narrow=narrow)
        primary = float(R)
    else:
        idx, rowT = hit0.wt, hit0.rowT
        primary = 0.0
    state = _initial_state(ro, rd)
    rays = torch.full((), primary, dtype=torch.float64, device=ro.x.device)

    for depth in range(max_depth):
        out, rng, rays8 = shade(state, rng, rowT, idx, tables.light_rows,
                                depth, tables.light_count, max_depth,
                                textures)
        state, idx, rowT = _sweep_bounce(tables, out, rays8, R, narrow)
        rays = rays + out[15].sum(dtype=torch.float64) \
            + out[26].sum(dtype=torch.float64)

    take = (state[15] > 0.5) & ~(state[19] > 0.5)
    g = torch.where(take, 1.0, 0.0)
    radiance = V3(state[10] + state[16] * g, state[11] + state[17] * g,
                  state[12] + state[18] * g)
    return radiance, rng, rays


def trace_pixels_dense(tables: WorldTables, camera24: torch.Tensor,
                       frame_count, jitter: torch.Tensor, width: int,
                       height: int, spp: int, max_depth: int,
                       with_stats: bool = False, textures=None,
                       seed_wt_idx: Optional[torch.Tensor] = None,
                       narrow: str = "jobs", row0: int = 0,
                       full_height: Optional[int] = None,
                       total_spp: Optional[int] = None, sample0: int = 0):
    """One progressive frame over the whole image: thin-lens primaries
    (the JAX package's `_trace_lanes`), traced by `ray_color_dense_rows`
    at max_depth > 0, with `textures` None (the 1x1 white placeholder) or
    a (level0, level1) texture pyramid, and by `ray_color_dense` at
    max_depth 0 (its one last bounce).

    camera24 (24,) f32 and jitter (2,) f32 live on the tables' device;
    `frame_count` is an int or a 0-d int64 tensor there (a captured frame
    step's, whose seeds are then computed on the device). Per-pixel RNG
    streams depend only on (pixel, frame, sample), as in the JAX package. `seed_wt_idx` ((H*W,) int32, -1 = miss, a G-buffer's
    wt_idx): seed every sample's bounce 0 from it instead of tracing
    primaries; each sample rebuilds the hit with its own ray, so at lens
    radius 0 the radiance is bit-identical to the traced path. `narrow`
    ("jobs" | "scan") picks the narrow phase of a multi-tile scene's
    sweeps (`ops/cuda_dense.py`); both give the same frame bit for bit.

    The sharding offsets are the JAX package's: row0 / full_height render
    rows [row0, row0 + height) of a full_height-tall frame with the
    frame's pixel indices and jitter; sample0 / total_spp render samples
    [sample0, sample0 + spp) of a total_spp-sample frame with the frame's
    RNG streams. At their defaults the frame is the whole image.

    Returns (H*W, 3) radiance averaged over spp; with with_stats=True,
    (radiance, rays) with rays the exact float64 device count (seeded
    frames exclude the G-buffer's own primary cast: count it where the
    G-buffer is rendered)."""
    if full_height is None:
        full_height = height
    if total_spp is None:
        total_spp = spp
    cam = camera24
    lens_radius = cam[3]
    lane = torch.arange(width * height, dtype=torch.int64,
                        device=tables.device)
    gx = lane % width
    gy = lane // width + row0
    px = gx.to(torch.float32)
    py = gy.to(torch.float32)
    p_idx = gy * width + gx
    rows_path = max_depth > 0
    if rows_path and seed_wt_idx is not None:
        seed_rows = seed_rows_from_wt_idx(tables, seed_wt_idx)

    cx = cy = cz = 0.0
    rays = 0.0
    for i in range(spp):
        rng = init_rng(p_idx, frame_count * total_spp + sample0 + i)
        rng, (dr1, dr2) = rand_n(rng, 2)
        dx, dy = bsdf.random_in_unit_disk(dr1, dr2)
        rdx = lens_radius * dx
        rdy = lens_radius * dy
        off = V3(cam[16] * rdx + cam[20] * rdy,
                 cam[17] * rdx + cam[21] * rdy,
                 cam[18] * rdx + cam[22] * rdy)

        u = (px + 0.5 + jitter[0] * width) / width
        v = 1.0 - (py + 0.5 + jitter[1] * full_height) / full_height
        d = V3(cam[4] + u * cam[8] + v * cam[12] - cam[0],
               cam[5] + u * cam[9] + v * cam[13] - cam[1],
               cam[6] + u * cam[10] + v * cam[14] - cam[2]) - off
        ro = V3(cam[0] + off.x, cam[1] + off.y, cam[2] + off.z)
        if rows_path:
            hit0 = None if seed_wt_idx is None else seed_rows
            col, _, r = ray_color_dense_rows(tables, ro, d, rng, max_depth,
                                             hit0=hit0, narrow=narrow,
                                             textures=textures)
        else:
            hit0 = None
            if seed_wt_idx is not None:
                hit0 = seed_hit_from_wt_idx(tables, textures, seed_wt_idx,
                                            ro, d)
            col, _, r = ray_color_dense(tables, textures, ro, d, rng,
                                        max_depth, hit0=hit0, narrow=narrow)
        cx, cy, cz = cx + col.x, cy + col.y, cz + col.z
        rays = rays + r
    inv = 1.0 / spp
    col = torch.stack([cx * inv, cy * inv, cz * inv], dim=-1)
    return (col, rays) if with_stats else col
