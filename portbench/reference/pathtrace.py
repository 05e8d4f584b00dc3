"""Plain reference path tracer: one progressive frame's radiance for chosen
pixels of a scene, textured or not.

It follows the estimator of the system under test (the per-ray loop of the
upstream WGSL shader, as the port states it): thin-lens primaries, a closest
hit found by testing every world triangle, next-event estimation over the
emissive triangles with the power heuristic, Lambert / GGX / dielectric
sampling, Russian roulette after depth 3, and counter-seeded PCG streams per
(pixel, sample stream). Every f32 operation is a separate PyTorch op in the
order the port's plain versions use, so agreement is bit for bit where the
CUDA kernels round as those do; a pixel whose path parts (a grazing hit
decided the other way by one rounding) shows as a large gap on that pixel
only.

A textured scene samples its `texture_2d_array` (`textures.py`) in the
four slots of a shading row's `tex` columns, at the hit's interpolated UVs:
the base colour (times the base-colour factor; at level 0 on bounce 0 and
at level 1 after it), the normal map (the same levels; the tangent frame
from the triangle's first edge), metallic-roughness (level 1: metallic
times B, roughness times G) and emissive (level 1); a light sample's
emission is the light's base colour times its texture at level 1, at the
sampled point's UVs. A scene that binds no texture takes none of these
operations.

Inputs are the native scene compiler's raw arrays and encoded images
(`world_tables`); this file imports nothing of the system under test.
`dtype` is the precision the whole frame is computed in: float32 as the
configuration states, or a lower one for the benchmark's control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import textures

PI = 3.141592653589793
M32 = 0xFFFFFFFF
T_MIN = 1e-3
T_MAX = 1e30
# Elements of one (lanes x triangles) block of the brute-force hit test.
BLOCK = 1 << 24

# The shade row layout: column ranges of one world triangle's attributes.
COLS = dict(v0=0, e1=3, e2=6, n0=9, n1=12, n2=15, uv0=18, uv1=20, uv2=22,
            base=24, mat=27, mrir=28, tex=31, emissive=35)


# -- numbers ------------------------------------------------------------------

def sqrt_rn(x):
    """The correctly rounded square root (ATen's CPU kernel is not)."""
    if x.device.type == "cuda" or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


class V:
    """A 3-vector of (N,) tensors."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def __add__(self, o):
        if isinstance(o, V):
            return V(self.x + o.x, self.y + o.y, self.z + o.z)
        return V(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V):
            return V(self.x - o.x, self.y - o.y, self.z - o.z)
        return V(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V):
            return V(self.x * o.x, self.y * o.y, self.z * o.z)
        return V(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V(-self.x, -self.y, -self.z)


def dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a, b):
    return V(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
             a.x * b.y - a.y * b.x)


def length(a):
    return sqrt_rn(dot(a, a))


def normalize(a):
    return a * (1.0 / torch.clamp(length(a), min=1e-20))


def sel(m, a, b):
    return V(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
             torch.where(m, a.z, b.z))


def max3(a):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


# -- random numbers -----------------------------------------------------------

def init_rng(pixel, stream: int):
    """u32 PCG state of (pixel, stream), carried in int64."""
    seed = (pixel + (stream & M32) * 719393) & M32
    seed = seed ^ 2747636419
    seed = (seed * 2654435769) & M32
    seed = seed ^ (seed >> 16)
    seed = (seed * 2654435769) & M32
    seed = seed ^ (seed >> 16)
    return (seed * 2654435769) & M32


def rand(state, dtype):
    """One PCG-RXS-M-XS draw: (state, uniform in [0, 1])."""
    old = state
    state = (old * 747796405 + 2891336453) & M32
    word = (state >> ((old >> 28) + 4)) ^ state
    word = (word >> 22) ^ word
    return state, (word.to(torch.float32) * 2.0 ** -32).to(dtype)


def rand_n(state, n, dtype):
    out = []
    for _ in range(n):
        state, u = rand(state, dtype)
        out.append(u)
    return state, out


def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


def frame_jitter(frame: int, width: int, height: int) -> np.ndarray:
    """Sub-pixel jitter (UV units) of a 1-based progressive frame."""
    i = (frame % 16) + 1
    return np.array([(halton(i, 2) - 0.5) / width,
                     (halton(i, 3) - 0.5) / height], np.float32)


def average_jitter(frames, width: int, height: int) -> np.ndarray:
    """The running mean of the jitters of `frames` (the frame counts one
    accumulation went through, in order), as the post-process reads it."""
    acc = np.zeros(2, np.float64)
    for k in frames:
        j = frame_jitter(k, width, height)
        acc = j.astype(np.float64) if k == 1 else acc + j
    return (acc / frames[-1]).astype(np.float32)


# -- scene --------------------------------------------------------------------

def _unit(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.maximum(n, 1e-20), v)


def world_tables(arrays: dict) -> dict:
    """Flatten the scene compiler's arrays (`topology`, `vertices`,
    `normals`, `instances`, `lights`, and for a textured scene `uvs` and
    `textures`, the encoded images) into world-space triangles: the
    Plucker features of the hit test, one 40-column shading row a
    triangle, the emissive triangles' rows, and the texture levels
    (`textures.levels`, None for a scene that binds no texture). The UV
    columns are filled only where some triangle binds a texture; raises
    on a texture index past the scene's images."""
    topo = np.asarray(arrays["topology"], np.uint32).reshape(-1, 20)
    tri_v = topo[:, 0:3].astype(np.int64)
    tri_geom = topo[:, 3].astype(np.int64)
    attrs = topo[:, 4:20].copy().view(np.float32)
    pos = np.asarray(arrays["vertices"], np.float32).reshape(-1, 4)[:, :3]
    nrm = np.asarray(arrays["normals"], np.float32).reshape(-1, 4)[:, :3]
    inst = np.asarray(arrays["instances"], np.float32).reshape(-1, 36)
    tf = inst[:, 0:16].reshape(-1, 4, 4).transpose(0, 2, 1)
    inv = inst[:, 16:32].reshape(-1, 4, 4).transpose(0, 2, 1)
    inst_geom = inst[:, 32:36].copy().view(np.uint32)[:, 2].astype(np.int64)
    lights = np.asarray(arrays["lights"], np.uint32).reshape(-1, 2) \
        .astype(np.int64)

    parts, light_rows_at, base = [], [], 0
    for i in range(inst.shape[0]):
        mine = np.nonzero(tri_geom == inst_geom[i])[0]
        if mine.size == 0:
            continue
        rot, trn, nrm_m = tf[i, :3, :3], tf[i, :3, 3], inv[i, :3, :3].T
        vi = tri_v[mine]
        p = [pos[vi[:, k]] @ rot.T + trn for k in range(3)]
        n = [_unit(nrm[vi[:, k]] @ nrm_m.T) for k in range(3)]
        where = {int(t): k for k, t in enumerate(mine)}
        light_rows_at += [base + where[int(t)]
                          for _, t in lights[lights[:, 0] == i]]
        base += mine.size
        parts.append((mine, *p, *n, vi))
    if not parts:
        raise ValueError("the scene has no triangles")
    mine, v0, v1, v2, n0, n1, n2, vi = (np.concatenate([q[k] for q in parts])
                                        for k in range(8))
    a = attrs[mine]
    tw = v0.shape[0]
    uv = np.zeros((tw, 6), np.float32)
    levels = None
    bound = a[:, 8:12][a[:, 8:12] >= 0]
    if bound.size:
        images = arrays["textures"]
        if bound.max() >= len(images):
            raise ValueError(f"texture index {int(bound.max())} past the "
                             f"scene's {len(images)} images")
        uvs = np.asarray(arrays["uvs"], np.float32).reshape(-1, 2)
        uv = np.concatenate([uvs[vi[:, k]] for k in range(3)], axis=1)
        levels = textures.levels(images)
    e1, e2 = v1 - v0, v2 - v0

    def edge(pa, pb):
        c = np.zeros((16, tw), np.float32)
        c[0:3] = np.cross(pa, pb).T
        c[3:6] = (pb - pa).T
        return c

    nn = np.cross(e1, e2)
    tn = np.zeros((16, tw), np.float32)
    tn[6:9] = -nn.T
    tn[9] = np.einsum("tj,tj->t", nn, v0)
    td = np.zeros((16, tw), np.float32)
    td[0:3] = nn.T
    shade = np.concatenate(
        [v0, e1, e2, n0, n1, n2, uv, a[:, 0:3], a[:, 3:4], a[:, 4:7],
         a[:, 8:12], a[:, 12:15], np.zeros((tw, 2), np.float32)],
        axis=1).astype(np.float32)
    return dict(features=np.stack([edge(v0, v1), edge(v1, v2), edge(v2, v0),
                                   tn, td]),   # (5, 16, T)
                shade=shade,
                lights=shade[np.asarray(light_rows_at, np.int64)]
                if light_rows_at else np.zeros((1, 40), np.float32),
                light_count=len(light_rows_at), textures=levels)


class Scene:
    """The world tables on a device, in one precision; `tex` the texture
    (level 0, level 1), or None."""

    def __init__(self, tables: dict, device, dtype=torch.float32):
        self.dtype = dtype
        self.tex = None
        if tables.get("textures") is not None:
            l0, l1 = tables["textures"]
            d0 = textures.Level(l0, device)
            self.tex = (d0, d0 if l1 is l0 else textures.Level(l1, device))
        # (5, 16, T): per Plucker group, the columns a lane's terms dot with
        self.f = torch.from_numpy(tables["features"]).to(device, dtype)
        self.shade = torch.from_numpy(tables["shade"]).to(device, dtype)
        self.lights = torch.from_numpy(tables["lights"]).to(device, dtype)
        self.light_count = int(tables["light_count"])
        self.tris = self.shade.shape[0]


def hits(scene: Scene, ro: V, rd: V, t_max, any_hit: bool):
    """Closest hit (t, idx, -1 = miss; a miss keeps t_max) of every lane
    over every triangle, or occlusion (bool) when any_hit. A triangle is
    hit when its three Plucker sides agree in sign, |n . d| >= 1e-6 and
    T_MIN < t < t_max; ties go to the lowest index. Only the lanes with
    t_max > 0 are tested: no triangle can hit the others."""
    n = ro.x.shape[0]
    dev = ro.x.device
    best_t = t_max.clone()
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    live = torch.nonzero(t_max > 0).flatten()
    if live.numel() == 0:
        return occ if any_hit else (best_t, best_i)
    step = max(1, min(scene.tris, BLOCK // live.numel()))
    dx, dy, dz, ox, oy, oz = (c[live][:, None] for c in
                              (rd.x, rd.y, rd.z, ro.x, ro.y, ro.z))
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    tm = t_max[live][:, None]
    lt = tm[:, 0].clone()
    li = torch.full_like(live, -1)
    lo = torch.zeros_like(live, dtype=torch.bool)
    for c0 in range(0, scene.tris, step):
        f = scene.f[:, :, c0:c0 + step]

        def side(g):
            return (dx * f[g, 0] + dy * f[g, 1] + dz * f[g, 2]
                    + mx * f[g, 3] + my * f[g, 4] + mz * f[g, 5])

        s0, s1, s2 = side(0), side(1), side(2)
        tn = ox * f[3, 6] + oy * f[3, 7] + oz * f[3, 8] + f[3, 9]
        td = dx * f[4, 0] + dy * f[4, 1] + dz * f[4, 2]
        inside = (torch.minimum(torch.minimum(s0, s1), s2) >= 0.0) | (
            torch.maximum(torch.maximum(s0, s1), s2) <= 0.0)
        ok = inside & (torch.abs(td) >= 1e-6)
        t = tn / torch.where(ok, td, 1.0)
        ok = ok & (t > T_MIN) & (t < tm)
        if any_hit:
            lo |= ok.any(dim=1)
            continue
        cmin, carg = torch.min(torch.where(ok, t, float("inf")), dim=1)
        upd = cmin < lt
        lt = torch.where(upd, cmin, lt)
        li = torch.where(upd, carg + c0, li)
    if any_hit:
        return occ.index_put_((live,), lo)
    return best_t.index_put_((live,), lt), best_i.index_put_((live,), li)


class Row:
    """Shading rows of the triangles hit (zeros for a miss)."""

    def __init__(self, table, idx):
        r = table[idx.clamp(min=0)]
        self.r = torch.where((idx >= 0)[:, None], r, 0.0)

    def v(self, name):
        c = COLS[name]
        return V(self.r[:, c], self.r[:, c + 1], self.r[:, c + 2])

    def f(self, name, k=0):
        return self.r[:, COLS[name] + k]


def refine_t(row: Row, ro: V, rd: V):
    """Moller-Trumbore distance to the known triangle of the row."""
    e1, e2 = row.v("e1"), row.v("e2")
    s = ro - row.v("v0")
    a = dot(e1, cross(rd, e2))
    f = 1.0 / torch.where(torch.abs(a) > 1e-20, a, 1e-20)
    return f * dot(e2, cross(s, e1))


def surface(row: Row, ro: V, rd: V):
    """(shading normal, geometric normal, barycentrics (u, v, w)) at the
    hit of the row."""
    v0, e1, e2 = row.v("v0"), row.v("e1"), row.v("e2")
    s = ro - v0
    h = cross(rd, e2)
    a = dot(e1, h)
    f = 1.0 / torch.where(torch.abs(a) > 1e-20, a, 1e-20)
    u = f * dot(s, h)
    v = f * dot(rd, cross(s, e1))
    w = 1.0 - u - v
    ln = normalize(row.v("n0") * w + row.v("n1") * u + row.v("n2") * v)
    return ln, normalize(cross(e1, e2)), (u, v, w)


def tex_uv(row: Row, u, v, w):
    """The row's texture coordinates at barycentrics: uv0 * w + uv1 * u +
    uv2 * v, per coordinate."""
    return tuple(row.f("uv0", k) * w + row.f("uv1", k) * u
                 + row.f("uv2", k) * v for k in (0, 1))


def textured(scene: Scene, row: Row, found, active, depth: int, ln, bary,
             albedo, metallic, rough, emissive) -> tuple:
    """The hit's surface with its textures sampled: (shading normal,
    albedo, metallic, roughness, emissive). Base colour and normal map read
    the lanes that found a triangle, at level 0 on bounce 0 and level 1
    after it; metallic-roughness and emissive the live lanes, at level 1."""
    u, v, w = bary
    l0, l1 = scene.tex
    level = l0 if depth == 0 else l1
    tu, tv = tex_uv(row, u, v, w)

    def slot(k, mask):
        return torch.where(mask, row.f("tex", k), -1.0).to(torch.int32)

    def tex(lvl, k, mask):
        return V(*textures.sample(lvl, slot(k, mask), tu, tv))

    albedo = albedo * tex(level, 0, found)
    n_map = tex(level, 2, found) * 2.0 - 1.0
    t_axis = normalize(row.v("e1"))
    b_axis = normalize(cross(ln, t_axis))
    mapped = normalize(t_axis * n_map.x + b_axis * n_map.y + ln * n_map.z)
    nrm = sel(found & (row.f("tex", 2) >= 0.0), mapped, ln)
    k_mr = slot(1, active)
    mr = V(*textures.sample(l1, k_mr, tu, tv))
    metallic = torch.where(k_mr >= 0, metallic * mr.z, metallic)
    rough = torch.where(k_mr >= 0, rough * mr.y, rough)
    emissive = emissive * tex(l1, 3, active)
    return nrm, albedo, metallic, rough, emissive


# -- BSDF ---------------------------------------------------------------------

def pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def reflect(i, n):
    return i - n * (2.0 * dot(n, i))


def refract(i, n, eta):
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = i * eta - n * (eta * cos_i + sqrt_rn(torch.clamp(k, min=0.0)))
    z = torch.zeros_like(out.x)
    return sel(k >= 0.0, out, V(z, z, z))


def onb(n):
    sign = torch.where(n.z >= 0.0, 1.0, -1.0).to(n.z.dtype)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    return (V(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x),
            V(b, sign + n.y * n.y * a, -n.y))


def to_world(u, v, w, a):
    return u * a.x + v * a.y + w * a.z


def ggx_d(n_dot_h, a2):
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (PI * d * d)


def ggx_g(n_dot_v, n_dot_l, a2):
    g1v = 2.0 * n_dot_v / (n_dot_v + sqrt_rn(a2 + (1.0 - a2)
                                                 * (n_dot_v * n_dot_v)))
    g1l = 2.0 * n_dot_l / (n_dot_l + sqrt_rn(a2 + (1.0 - a2)
                                                 * (n_dot_l * n_dot_l)))
    return g1v * g1l


def fresnel(cos_theta, f0):
    p = pow5(torch.clamp(1.0 - cos_theta, 0.0, 1.0))
    return f0 + (V(p, p, p) - f0 * p)


def eval_ggx(n, v, l, rough, f0):
    h = normalize(v + l)
    n_v = torch.clamp(dot(n, v), min=1e-4)
    n_l = torch.clamp(dot(n, l), min=1e-4)
    n_h = torch.clamp(dot(n, h), min=1e-4)
    v_h = torch.clamp(dot(v, h), min=1e-4)
    a2 = rough * rough
    return fresnel(v_h, f0) * (ggx_d(n_h, a2) * ggx_g(n_v, n_l, a2)
                               / (4.0 * n_v * n_l))


def ggx_pdf(n, v, l, rough):
    h = normalize(v + l)
    n_h = dot(n, h)
    v_h = torch.clamp(dot(v, h), min=0.0)
    return (ggx_d(n_h, rough * rough) * torch.clamp(n_h, min=0.0)) / (
        4.0 * torch.clamp(v_h, min=1e-8))


def sample_diffuse(n, albedo, r1, r2):
    u, v = onb(n)
    phi = 2.0 * PI * r1
    cos_t = sqrt_rn(torch.clamp(1.0 - r2, min=0.0))
    sin_t = sqrt_rn(torch.clamp(r2, min=0.0))
    d = to_world(u, v, n, V(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                            cos_t))
    pdf = torch.clamp(dot(n, d), min=0.0) / PI
    return d, pdf, albedo, torch.zeros_like(r1, dtype=torch.bool)


def sample_ggx(n, v, rough, f0, r1, r2):
    a = rough
    phi = 2.0 * PI * r1
    cos_t = sqrt_rn(torch.clamp((1.0 - r2) / (1.0 + (a * a - 1.0) * r2),
                                min=0.0))
    sin_t = sqrt_rn(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    u, vv = onb(n)
    h = to_world(u, vv, n, V(sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                             cos_t))
    l = reflect(-v, h)
    below = dot(n, l) <= 0.0
    n_v = torch.clamp(dot(n, v), min=1e-4)
    n_l = torch.clamp(dot(n, l), min=1e-4)
    n_h = torch.clamp(dot(n, h), min=1e-4)
    v_h = torch.clamp(dot(v, h), min=1e-4)
    a2 = a * a
    d = ggx_d(n_h, a2)
    g = ggx_g(n_v, n_l, a2)
    f = fresnel(v_h, f0)
    pdf = (d * n_h) / (4.0 * v_h)
    scale = torch.where(pdf > 1e-6, g * v_h / (n_v * n_h), 0.0)
    tp = f * scale
    pdf = torch.where(below, 0.0, pdf)
    z = torch.zeros_like(pdf)
    z3 = V(z, z, z)
    return sel(below, z3, l), pdf, sel(below, z3, tp), rough < 0.01


def sample_dielectric(dirn, normal, ior, albedo, r1):
    front = dot(dirn, normal) < 0.0
    ratio = torch.where(front, 1.0 / ior, ior)
    n = sel(front, normal, -normal)
    unit = normalize(dirn)
    cos_t = torch.clamp(dot(-unit, n), max=1.0)
    sin_t = sqrt_rn(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    refl = r0 + (1.0 - r0) * pow5(torch.clamp(1.0 - cos_t, 0.0, 1.0))
    do_reflect = (ratio * sin_t > 1.0) | (refl > r1)
    d = sel(do_reflect, reflect(unit, n), refract(unit, n, ratio))
    return (d, torch.ones_like(r1), albedo,
            torch.ones_like(r1, dtype=torch.bool))


def power(a, b):
    a2, b2 = a * a, b * b
    return a2 / torch.clamp(a2 + b2, min=1e-20)


def offset_eps(p):
    m = torch.maximum(torch.abs(p.x), torch.maximum(torch.abs(p.y),
                                                    torch.abs(p.z)))
    return 1e-4 * torch.clamp(m, min=1.0)


# -- the frame ----------------------------------------------------------------

def sample_light(scene: Scene, hit_p, r0, r1, r2):
    """NEE over the emissive triangles: (L, direction, distance, pdf)."""
    lc = scene.light_count
    lc_f = float(max(lc, 1))
    pick = torch.clamp((r0 * lc_f).to(torch.int32), 0, max(lc - 1, 0))
    row = Row(scene.lights, pick.long())
    v0, e1, e2 = row.v("v0"), row.v("e1"), row.v("e2")
    sq = sqrt_rn(r1)
    u = 1.0 - sq
    v = r2 * sq
    w = 1.0 - u - v
    p = v0 + e1 * v + e2 * w
    cr = cross(e1, e2)
    n_raw = normalize(cr)
    area = length(cr) * 0.5
    l_dir = p - hit_p
    dist_sq = dot(l_dir, l_dir)
    dist = sqrt_rn(dist_sq)
    unit = l_dir * (1.0 / torch.clamp(dist, min=1e-20))
    cos_l = torch.clamp(dot(n_raw, -unit), min=0.0)
    pdf = dist_sq / torch.clamp(cos_l * area, min=1e-20) / lc_f
    valid = (cos_l >= 1e-6) & (area > 0.0) & (lc > 0)
    emit = row.v("base")
    if scene.tex is not None:
        # p's vertex weights are (u, v, w): uv0 * u + uv1 * v + uv2 * w.
        tu, tv = tex_uv(row, v, w, u)
        emit = emit * V(*textures.sample(
            scene.tex[1], row.f("tex", 0).to(torch.int32), tu, tv))
    return emit, unit, dist, torch.where(valid, pdf, 0.0)


def light_pdf(scene: Scene, row: Row, t, l_dir):
    cr = cross(row.v("e1"), row.v("e2"))
    area = length(cr) * 0.5
    cos_l = torch.clamp(dot(normalize(cr), -l_dir), min=0.0)
    lc_f = float(max(scene.light_count, 1))
    pdf = (t * t) / torch.clamp(cos_l * area, min=1e-20) / lc_f
    return torch.where(cos_l >= 1e-4, pdf, 0.0)


def primaries(camera, pixels, frame: int, width: int, height: int,
              dtype, *, stream: int | None = None, jitter=None):
    """Thin-lens primary rays of `pixels` (int64 row-major indices) and
    their PCG states for one sample of a progressive frame: the PCG stream
    `stream` (by default the frame's own, `frame`) under the sub-pixel
    `jitter`, the two f32 values the step was given (by default the
    frame's, `frame_jitter(frame, width, height)`). A sharded step's sample
    is one of several streams under the one jitter of its frame."""
    dev = pixels.device
    cam = torch.as_tensor(np.asarray(camera, np.float32)).to(dev, dtype)
    if jitter is None:
        jitter = frame_jitter(frame, width, height)
    jit = torch.as_tensor(jitter, dtype=torch.float32).to(dev, dtype)
    rng = init_rng(pixels, frame if stream is None else stream)
    rng, (a, b) = rand_n(rng, 2, dtype)
    r = sqrt_rn(a)
    theta = 2.0 * PI * b
    rdx = cam[3] * (r * torch.cos(theta))
    rdy = cam[3] * (r * torch.sin(theta))
    off = V(cam[16] * rdx + cam[20] * rdy, cam[17] * rdx + cam[21] * rdy,
            cam[18] * rdx + cam[22] * rdy)
    px = (pixels % width).to(dtype)
    py = (pixels // width).to(dtype)
    u = (px + 0.5 + jit[0] * width) / width
    v = 1.0 - (py + 0.5 + jit[1] * height) / height
    d = V(cam[4] + u * cam[8] + v * cam[12] - cam[0],
          cam[5] + u * cam[9] + v * cam[13] - cam[1],
          cam[6] + u * cam[10] + v * cam[14] - cam[2]) - off
    o = V(cam[0] + off.x, cam[1] + off.y, cam[2] + off.z)
    return o, d, rng


def radiance(scene: Scene, camera, pixels, frame: int, width: int,
             height: int, max_depth: int, *, stream: int | None = None,
             jitter=None):
    """(radiance (N, 3), rays (N,) int64) of one progressive frame at the
    given pixels: the rays each pixel's path traced (its primary, and per
    bounce its NEE shadow ray and its extension ray when cast). `stream`
    and `jitter` as in `primaries`."""
    dt = scene.dtype
    ro, rd, rng = primaries(camera, pixels, frame, width, height, dt,
                            stream=stream, jitter=jitter)
    n = pixels.shape[0]
    dev = pixels.device
    ones = torch.ones(n, dtype=dt, device=dev)
    zeros = torch.zeros(n, dtype=dt, device=dev)
    t_max = torch.full((n,), T_MAX, dtype=dt, device=dev)
    t, idx = hits(scene, ro, rd, t_max, False)
    row = Row(scene.shade, idx)
    hit_t = torch.where(idx >= 0, refine_t(row, ro, rd), t)
    active = idx >= 0
    tp = V(ones, ones, ones)
    rad = V(zeros, zeros, zeros)
    prev_pdf = zeros
    specular = torch.ones(n, dtype=torch.bool, device=dev)
    rays = torch.ones(n, dtype=torch.int64, device=dev)
    for depth in range(max_depth):
        last = depth == max_depth - 1
        nrm, geo, bary = surface(row, ro, rd)
        metallic = row.f("mrir", 0)
        rough = row.f("mrir", 1)
        emissive = row.v("emissive")
        albedo = row.v("base")
        if scene.tex is not None:
            nrm, albedo, metallic, rough, emissive = textured(
                scene, row, idx >= 0, active, depth, nrm, bary, albedo,
                metallic, rough, emissive)
        mat = row.f("mat").to(torch.int32)
        hit_p = ro + rd * hit_t
        normal = sel(dot(rd, nrm) < 0.0, nrm, -nrm)
        geom_n = sel(dot(rd, geo) < 0.0, geo, -geo)
        rough = torch.clamp(rough, min=0.005)
        ior = row.f("mrir", 2)
        f0 = albedo * metallic + (0.04 * (1.0 - metallic))

        is_light = mat == 3
        has_em = is_light | (length(emissive) > 1e-4)
        em = sel(is_light, albedo, emissive)
        lp = light_pdf(scene, row, hit_t, rd)
        mis = torch.where(specular, 1.0, power(prev_pdf, lp))
        rad = rad + tp * em * torch.where(active & has_em, mis, 0.0)
        active = active & ~is_light

        rng, (r0, r1, r2) = rand_n(rng, 3, dt)
        L, ldir, ldist, lpdf = sample_light(scene, hit_p, r0, r1, r2)
        nee = active & (mat != 2) & (lpdf > 0.0)
        eps = offset_eps(hit_p)
        end_eps = torch.maximum(eps, offset_eps(hit_p + ldir * ldist))
        n_l = torch.clamp(dot(normal, ldir), min=0.0)
        diff = mat == 0
        b_val = sel(diff, albedo * (1.0 / PI),
                    eval_ggx(normal, -rd, ldir, rough, f0))
        b_pdf = torch.where(diff, n_l / PI, ggx_pdf(normal, -rd, ldir, rough))
        nee_tp = tp

        rng, (s1, s2) = rand_n(rng, 2, dt)
        d_d, p_d, t_d, k_d = sample_diffuse(normal, albedo, s1, s2)
        d_m, p_m, t_m, k_m = sample_ggx(normal, -rd, rough, f0, s1, s2)
        d_g, p_g, t_g, k_g = sample_dielectric(rd, normal, ior, albedo, s1)
        is_m, is_g = mat == 1, mat == 2
        dirn = sel(is_g, d_g, sel(is_m, d_m, d_d))
        pdf = torch.where(is_g, p_g, torch.where(is_m, p_m, p_d))
        stp = sel(is_g, t_g, sel(is_m, t_m, t_d))
        spec = torch.where(is_g, k_g, torch.where(is_m, k_m, k_d))
        bad = (mat != 2) & (dot(dirn, geom_n) <= 0.0)
        pdf = torch.where(bad, 0.0, pdf)
        stp = stp * torch.where(bad, 0.0, 1.0)

        active = active & (pdf > 0.0) & (length(stp) > 0.0)
        tp = sel(active, tp * stp, tp)
        off_n = sel(dot(dirn, geom_n) > 0.0, geom_n, -geom_n)
        ro = sel(active, hit_p + off_n * eps, ro)
        rd = sel(active, dirn, rd)
        prev_pdf = torch.where(active, pdf, prev_pdf)
        specular = torch.where(active, spec, specular)

        rng, rr = rand(rng, dt)
        p = max3(tp)
        do_rr = active & (depth > 3)
        active = active & ~(do_rr & (rr > p))
        tp = tp * torch.where(do_rr & (rr <= p),
                              1.0 / torch.clamp(p, min=1e-20), 1.0)

        sro = hit_p + geom_n * eps
        s_tmax = torch.where(nee, ldist - 2.0 * end_eps, 0.0)
        occluded = hits(scene, sro, ldir, s_tmax, True)
        do_next = active if not last else torch.zeros_like(active)
        if not last:
            t, idx = hits(scene, ro, rd, torch.where(do_next, T_MAX, 0.0)
                          .to(dt), False)
            row = Row(scene.shade, idx)
            hit_t = torch.where(idx >= 0, refine_t(row, ro, rd), t)
        take = nee & ~occluded & (b_pdf > 0.0)
        wgt = torch.where(take, power(lpdf, b_pdf) * n_l
                          / torch.clamp(lpdf, min=1e-20), 0.0)
        rad = rad + nee_tp * b_val * L * wgt
        rays = rays + nee.long() + do_next.long()
        if not last:
            active = do_next & (idx >= 0)
            hit_t = torch.where(active, hit_t, 0.0)
    return torch.stack([rad.x, rad.y, rad.z], dim=-1), rays
