"""One bounce of shading: the plain `shade_step` and the CUDA shade kernel.

The port of the JAX package's `ops/shade_rows.py`. `shade_step` is its
`shade_step` operation for operation: the hit rebuilt from the winner row,
emissive light with MIS, a NEE light sample, Lambert / GGX / dielectric
sampling with the geometric-normal guard, Russian roulette after depth 3,
and the resolution of the previous bounce's NEE. Six PCG draws a bounce, in
the same order: 3 NEE, 2 BSDF, 1 RR.

Textures: the JAX kernel covers the 1x1 white texel only (a TPU kernel
cannot gather texels), and JAX shades textured scenes with its per-ray
`ray_color_dense`. The port samples textures here as that function does:
with `textures=None` the white texel, bit for bit as before; with a
(level0, level1) quad-table pyramid (`ops/fetch.TexLevel`), the base
colour and the normal map at level 0 on bounce 0 and at level 1 after it,
and metallic-roughness, emissive and the picked light's base colour at
level 1 (`ops/fetch.sample_texture_v3`). The plain version skips a
sample that no lane needs, as JAX skips it (`lax.cond(jnp.any(...))`).

Kernel: `csrc/shade_rows.cu`, which replaces `_shade_kernel` (whose body is
`shade_step`), instantiated once for the white texel and once with texture
sampling. It also writes the next fused sweep's (8, 2R) ray stack, shadow
lanes first, so the bounce loop needs no concatenation; the plain path
builds the same stack with `next_rays`.

State row layout (f32, (K, R) lane-minor; rows 0-14 shared by input and
output):
   0 active        1-3 ro         4-6 rd        7-9 throughput
  10-12 radiance  13 prev_pdf    14 specular_bounce
  in : 15 nee_prev (prev bounce's shadow-lane mask)
       16-18 pending_nee (prev bounce's unresolved NEE contribution)
       19 occluded_prev (prev fused sweep's shadow verdict)
  out: 15 nee_lane  16-18 pending_nee  19-21 sro  22-24 srd
       25 s_tmax    26 do_next

The rng words are int64 tensors holding u32 values (see ops/rng.py).
"""

from __future__ import annotations

import torch

from .. import kernels
from . import bsdf_v3 as bsdf
from .bsdf_v3 import PI, power_heuristic
from .dense import T_MAX
from .fetch import TexLevel, sample_texture_v3, tex_level
from .rng import rand_n, rand_pcg
from .v3 import (V3, cross, dot, length, max_component, normalize, rows,
                 sqrt_rn, where)
from ..render.worldtris import SHADE_COLS, SHADE_K

NS_IN = 20
NS_OUT = 27
# Output rows that hold 0/1 flags: active, specular_bounce, nee_lane, do_next
FLAG_ROWS = (0, 14, 15, 26)
# Texture slots: the four `tex` columns of a shade row.
BASE, METAL_ROUGH, NORMAL, EMISSIVE = range(4)
# First rows of the three vertices' texture coordinates in a shade row.
UV0, UV1, UV2 = (SHADE_COLS[k][0] for k in ("uv0", "uv1", "uv2"))


def _rv3(rowT, name) -> V3:
    return rows(rowT, SHADE_COLS[name][0])


def _rf(rowT, name, k=0):
    return rowT[SHADE_COLS[name][0] + k]


def _offset_eps(p: V3):
    m = torch.maximum(torch.abs(p.x),
                      torch.maximum(torch.abs(p.y), torch.abs(p.z)))
    return 1e-4 * torch.clamp(m, min=1.0)


def _sample(textures, level: int, tex, u, v) -> V3:
    """A slot's sample at one pyramid level; white where the lane's index
    is < 0, and for every lane when none needs the sample."""
    need = bool((tex >= 0).any())
    return sample_texture_v3(tex_level(textures, level) if need else None,
                             tex, u, v, plain=True)


def _tex_index(rowT, k: int, mask):
    """Texture slot k's index per lane, -1 where `mask` is False (a miss
    lane's zeroed row would read as texture 0)."""
    return torch.where(mask, _rf(rowT, "tex", k), -1.0).to(torch.int32)


def shade_step(state, rng, rowT, idx, light_rows, depth: int,
               light_count: int, max_depth: int, textures=None):
    """One bounce over (R,) lanes, plain PyTorch.

    state (NS_IN, R) f32; rng (R,) int64; rowT (SHADE_K, R) f32 winner rows;
    idx (R,) int32 winner index (-1 miss); light_rows (L, SHADE_K) f32;
    textures None (the white texel) or a (level0, level1) TexLevel pyramid.
    Returns (state (NS_OUT, R) f32, rng (R,) int64)."""
    ro = rows(state, 1)
    rd = rows(state, 4)
    throughput = rows(state, 7)
    radiance = rows(state, 10)
    prev_pdf = state[13]
    specular_bounce = state[14] > 0.5
    nee_prev = state[15] > 0.5
    pending = rows(state, 16)
    occluded_prev = state[19] > 0.5

    # --- resolve the PREVIOUS bounce's NEE with this sweep's occlusion ---
    take_prev = nee_prev & ~occluded_prev
    radiance = radiance + pending * torch.where(take_prev, 1.0, 0.0)

    idx_ok = idx >= 0
    active = (state[0] > 0.5) & idx_ok

    # --- hit reconstruction from the winner row (white texel) ---
    v0 = _rv3(rowT, "v0")
    e1 = _rv3(rowT, "e1")
    e2 = _rv3(rowT, "e2")
    sv = ro - v0
    h = cross(rd, e2)
    a = dot(e1, h)
    f = 1.0 / torch.where(torch.abs(a) > 1e-20, a, 1e-20)
    u = f * dot(sv, h)
    q = cross(sv, e1)
    v = f * dot(rd, q)
    w = 1.0 - u - v
    hit_t = torch.where(idx_ok, f * dot(e2, q), 0.0)

    ln = normalize(_rv3(rowT, "n0") * w + _rv3(rowT, "n1") * u
                   + _rv3(rowT, "n2") * v)
    nt_on = idx_ok & (_rf(rowT, "tex", 2) >= 0.0)
    t_axis = normalize(e1)
    b_axis = normalize(cross(ln, t_axis))
    s_geom = normalize(cross(e1, e2))
    albedo = _rv3(rowT, "base_color")
    if textures is None:
        # white texel: n_map = (1,1,1)*2-1 = (1,1,1)
        ln_mapped = normalize(t_axis + b_axis + ln)
    else:
        # The hit's texture coordinates; base colour and normal map at
        # level 0 on bounce 0, at level 1 after it.
        tex_u = rowT[UV0] * w + rowT[UV1] * u + rowT[UV2] * v
        tex_v = rowT[UV0 + 1] * w + rowT[UV1 + 1] * u + rowT[UV2 + 1] * v
        level = 0 if depth == 0 else 1
        albedo = albedo * _sample(textures, level,
                                  _tex_index(rowT, BASE, idx_ok), tex_u,
                                  tex_v)
        n_map = _sample(textures, level, _tex_index(rowT, NORMAL, idx_ok),
                        tex_u, tex_v) * 2.0 - 1.0
        ln_mapped = normalize(t_axis * n_map.x + b_axis * n_map.y
                              + ln * n_map.z)
    s_normal = where(nt_on, ln_mapped, ln)

    hit_p = ro + rd * hit_t
    normal = where(dot(rd, s_normal) < 0.0, s_normal, -s_normal)
    geom_n = where(dot(rd, s_geom) < 0.0, s_geom, -s_geom)

    mat = _rf(rowT, "mat")
    metallic = _rf(rowT, "mrir", 0)
    roughness = _rf(rowT, "mrir", 1)
    emissive = _rv3(rowT, "emissive")
    if textures is not None:
        # metallic-roughness and emissive: level 1, live lanes only.
        tex_mr = _tex_index(rowT, METAL_ROUGH, active)
        mr = _sample(textures, 1, tex_mr, tex_u, tex_v)
        metallic = torch.where(tex_mr >= 0, metallic * mr.z, metallic)
        roughness = torch.where(tex_mr >= 0, roughness * mr.y, roughness)
        emissive = emissive * _sample(textures, 1,
                                      _tex_index(rowT, EMISSIVE, active),
                                      tex_u, tex_v)
    roughness = torch.clamp(roughness, min=0.005)
    ior = _rf(rowT, "mrir", 2)
    f0 = albedo * metallic + (0.04 * (1.0 - metallic))

    # --- emissive / light hit with MIS ---
    is_light = mat == 3.0
    has_em = is_light | (length(emissive) > 1e-4)
    em_val = where(is_light, albedo, emissive)
    cr = cross(e1, e2)
    area = length(cr) * 0.5
    n_raw = normalize(cr)
    cos_tl = torch.clamp(dot(n_raw, -rd), min=0.0)
    lc_f = float(max(light_count, 1))
    lp = (hit_t * hit_t) / torch.clamp(cos_tl * area, min=1e-20) / lc_f
    lp = torch.where(cos_tl >= 1e-4, lp, 0.0)
    mis_w = torch.where(specular_bounce, 1.0, power_heuristic(prev_pdf, lp))
    add = torch.where(active & has_em, mis_w, 0.0)
    radiance = radiance + throughput * em_val * add
    active = active & ~is_light

    # --- NEE light sample: a direct, clipped index into light_rows ---
    rng, (r0, r1, r2) = rand_n(rng, 3)
    pick = torch.clamp((r0 * lc_f).to(torch.int64), 0,
                       max(light_count - 1, 0))
    lrow = light_rows[pick].T  # (SHADE_K, R)
    lv0 = _rv3(lrow, "v0")
    le1 = _rv3(lrow, "e1")
    le2 = _rv3(lrow, "e2")
    sqrt_r1 = sqrt_rn(r1)
    lu = 1.0 - sqrt_r1
    lv = r2 * sqrt_r1
    lpnt = lv0 + le1 * lv + le2 * (1.0 - lu - lv)
    lcr = cross(le1, le2)
    ln_raw = normalize(lcr)
    larea = length(lcr) * 0.5
    l_dir = lpnt - hit_p
    dist_sq = dot(l_dir, l_dir)
    ldist = sqrt_rn(dist_sq)
    ldir = l_dir * (1.0 / torch.clamp(ldist, min=1e-20))
    cos_theta_l = torch.clamp(dot(ln_raw, -ldir), min=0.0)
    L = _rv3(lrow, "base_color")
    if textures is not None:
        # The light's base colour at level 1; its barycentric order is
        # uv0 * u + uv1 * v + uv2 * w, not the hit's.
        lw = 1.0 - lu - lv
        ltex_u = lrow[UV0] * lu + lrow[UV1] * lv + lrow[UV2] * lw
        ltex_v = lrow[UV0 + 1] * lu + lrow[UV1 + 1] * lv + lrow[UV2 + 1] * lw
        L = L * _sample(textures, 1, _rf(lrow, "tex", BASE).to(torch.int32),
                        ltex_u, ltex_v)
    lpdf = dist_sq / torch.clamp(cos_theta_l * larea, min=1e-20) / lc_f
    lvalid = (light_count > 0) & (cos_theta_l >= 1e-6) & (larea > 0.0)
    lpdf = torch.where(lvalid, lpdf, 0.0)

    nee_lane = active & (mat != 2.0) & (lpdf > 0.0)
    eps = _offset_eps(hit_p)
    end_eps = torch.maximum(eps, _offset_eps(hit_p + ldir * ldist))
    n_dot_l = torch.clamp(dot(normal, ldir), min=0.0)
    is_diff = mat == 0.0
    bsdf_val = where(is_diff, bsdf.eval_diffuse(albedo),
                     bsdf.eval_ggx(normal, -rd, ldir, roughness, f0))
    bsdf_pdf = torch.where(is_diff, n_dot_l / PI,
                           bsdf.ggx_pdf(normal, -rd, ldir, roughness))
    wgt = torch.where(nee_lane & (bsdf_pdf > 0.0),
                      power_heuristic(lpdf, bsdf_pdf) * n_dot_l
                      / torch.clamp(lpdf, min=1e-20), 0.0)
    new_pending = throughput * bsdf_val * L * wgt

    # --- BSDF sampling ---
    rng, (s1, s2) = rand_n(rng, 2)
    sc_d = bsdf.sample_diffuse(normal, albedo, s1, s2)
    sc_m = bsdf.sample_ggx(normal, -rd, roughness, f0, s1, s2)
    sc_g = bsdf.sample_dielectric(rd, normal, ior, albedo, s1)
    is_m = mat == 1.0
    is_g = mat == 2.0
    dirn = where(is_g, sc_g.dir, where(is_m, sc_m.dir, sc_d.dir))
    pdf = torch.where(is_g, sc_g.pdf, torch.where(is_m, sc_m.pdf, sc_d.pdf))
    tp = where(is_g, sc_g.throughput,
               where(is_m, sc_m.throughput, sc_d.throughput))
    is_spec = torch.where(is_g, sc_g.is_specular,
                          torch.where(is_m, sc_m.is_specular,
                                      sc_d.is_specular))

    bad = (mat != 2.0) & (dot(dirn, geom_n) <= 0.0)
    pdf = torch.where(bad, 0.0, pdf)
    tp = tp * torch.where(bad, 0.0, 1.0)

    active2 = active & (pdf > 0.0) & (length(tp) > 0.0)
    throughput2 = where(active2, throughput * tp, throughput)
    off_n = where(dot(dirn, geom_n) > 0.0, geom_n, -geom_n)
    ro_next = where(active2, hit_p + off_n * eps, ro)
    rd_next = where(active2, dirn, rd)
    prev_pdf2 = torch.where(active2, pdf, prev_pdf)
    spec2 = torch.where(active2, is_spec, specular_bounce)

    # --- Russian roulette after depth 3 ---
    rng, rr = rand_pcg(rng)
    p = max_component(throughput2)
    do_rr = active2 & (depth > 3)
    active3 = active2 & ~(do_rr & (rr > p))
    scale = torch.where(do_rr & (rr <= p),
                        1.0 / torch.clamp(p, min=1e-20), 1.0)
    throughput3 = throughput2 * scale

    do_next = active3 & (depth < max_depth - 1)
    active_out = do_next if depth < max_depth - 1 else active3

    sro = hit_p + geom_n * eps
    s_tmax = torch.where(nee_lane, ldist - 2.0 * end_eps, 0.0)

    state_out = torch.stack([
        active_out.float(), ro_next.x, ro_next.y, ro_next.z,
        rd_next.x, rd_next.y, rd_next.z,
        throughput3.x, throughput3.y, throughput3.z,
        radiance.x, radiance.y, radiance.z,
        prev_pdf2, spec2.float(),
        nee_lane.float(),
        new_pending.x, new_pending.y, new_pending.z,
        sro.x, sro.y, sro.z,
        ldir.x, ldir.y, ldir.z,
        s_tmax, do_next.float(),
    ])
    return state_out, rng


def next_rays(out: torch.Tensor) -> torch.Tensor:
    """The next fused sweep's (8, 2R) ray stack from a (NS_OUT, R) shade
    output: shadow lanes [0, R) (sro, srd, s_tmax), extension lanes
    [R, 2R) (ro, rd, T_MAX where do_next, else 0 = inactive)."""
    R = out.shape[1]
    r8 = torch.empty((8, 2 * R), dtype=torch.float32, device=out.device)
    r8[0:3, :R] = out[22:25]
    r8[3:6, :R] = out[19:22]
    r8[6, :R] = out[25]
    r8[0:3, R:] = out[4:7]
    r8[3:6, R:] = out[1:4]
    r8[6, R:] = torch.where(out[26] > 0.5, T_MAX, 0.0)
    r8[7] = 0.0
    return r8


def _check_level(level: TexLevel, name: str, dev) -> tuple:
    """A texture level's (int4 table, K, TH, TW) for the textured kernel."""
    kernels.check(level.flat, name, torch.int32, device=dev)
    k, th, tw = level.shape
    if tuple(level.flat.shape) != (k * th * tw, 4) or min(k, th, tw) < 1:
        raise ValueError(f"{name}: shape {tuple(level.flat.shape)} for "
                         f"levels {level.shape}")
    if level.flat.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    return kernels.ptr(level.flat), k, th, tw


def shade(state, rng, rowT, idx, light_rows, depth: int, light_count: int,
          max_depth: int, textures=None):
    """One bounce: (state_out (NS_OUT, R), rng (R,), rays8 (8, 2R)).

    On the CPU: `shade_step` + `next_rays`. On CUDA: the shade kernel, its
    textured instantiation when `textures` is a (level0, level1)
    pyramid."""
    if state.device.type == "cpu":
        out, rng = shade_step(state, rng, rowT, idx, light_rows, depth,
                              light_count, max_depth, textures)
        return out, rng, next_rays(out)
    dev = state.device
    R = state.shape[1]
    kernels.check(state, "state", torch.float32, (NS_IN, R), dev)
    kernels.check(rng, "rng", torch.int64, (R,), dev)
    kernels.check(rowT, "rowT", torch.float32, (SHADE_K, R), dev)
    kernels.check(idx, "idx", torch.int32, (R,), dev)
    kernels.check(light_rows, "light_rows", torch.float32, device=dev)
    if light_rows.dim() != 2 or light_rows.shape[1] != SHADE_K \
            or light_rows.shape[0] < max(light_count, 1):
        raise ValueError(f"light_rows: shape {tuple(light_rows.shape)} "
                         f"for {light_count} lights")
    if textures is not None:
        levels = (*_check_level(tex_level(textures, 0), "textures[0]", dev),
                  *_check_level(tex_level(textures, 1), "textures[1]", dev))
    out = torch.empty((NS_OUT, R), dtype=torch.float32, device=dev)
    rng_out = torch.empty(R, dtype=torch.int64, device=dev)
    rays8 = torch.empty((8, 2 * R), dtype=torch.float32, device=dev)
    lib = kernels.library()
    args = (kernels.ptr(state), kernels.ptr(rng), kernels.ptr(rowT),
            kernels.ptr(idx), kernels.ptr(light_rows), light_count, depth,
            max_depth, R)
    outs = (kernels.ptr(out), kernels.ptr(rng_out), kernels.ptr(rays8),
            kernels.stream(dev))
    with torch.cuda.device(dev):
        if textures is None:
            code = lib.wrt_shade_rows(*args, *outs)
        else:
            code = lib.wrt_shade_rows_textured(*args, *levels, *outs)
    kernels.raise_on_error(code, "shade_rows")
    kernels.launches["shade_rows"] += 1
    if textures is not None:
        kernels.launches["shade_rows_tex"] += 1
    return out, rng_out, rays8
