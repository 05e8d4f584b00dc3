"""BSDF evaluation and sampling over (R, 3) vectors: the BVH path's form.

The port of the JAX package's `ops/bsdf.py`, operation for operation:
cosine-hemisphere Lambert through a branchless orthonormal basis, GGX
metal (D sampling, Smith G, Schlick F, pdf D * NdotH / (4 VdotH), specular
below roughness 0.01), the Schlick dielectric and the power heuristic.
Every branch is evaluated on every lane and combined with selects.

The dense path's component-SoA twin is `ops/bsdf_v3.py`; the two stay
apart, as they are in the JAX package. Sums of three run left to right,
integer powers are the products XLA lowers them to, and square roots are
correctly rounded on every device (`v3.sqrt_rn`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bsdf_v3 import pow5
from .v3 import sqrt_rn

PI = 3.141592653589793


def dot(a, b):
    """Sum over the last axis of three, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        [a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def norm(v):
    return sqrt_rn(dot(v, v))


def normalize(v):
    return v / torch.clamp(norm(v), min=1e-20)[..., None]


def reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    """WGSL refract(): the zero vector on total internal reflection."""
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = eta[..., None] * i \
        - (eta * cos_i + sqrt_rn(torch.clamp(k, min=0.0)))[..., None] * n
    return torch.where((k >= 0.0)[..., None], out, 0.0)


def build_onb(n):
    """Branchless orthonormal basis about n: (u, v)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    u = torch.stack([1.0 + sign * (n[..., 0] * n[..., 0]) * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    v = torch.stack([b, sign + (n[..., 1] * n[..., 1]) * a, -n[..., 1]],
                    dim=-1)
    return u, v


def local_to_world(u, v, w, a):
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w


def cosine_hemisphere(n, r1, r2):
    """Cosine-weighted direction about n."""
    u, v = build_onb(n)
    phi = 2.0 * PI * r1
    cos_theta = sqrt_rn(torch.clamp(1.0 - r2, min=0.0))
    sin_theta = sqrt_rn(torch.clamp(r2, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_theta,
                         torch.sin(phi) * sin_theta, cos_theta], dim=-1)
    return local_to_world(u, v, n, local)


def random_in_unit_disk(r1, r2):
    r = sqrt_rn(r1)
    theta = 2.0 * PI * r2
    return r * torch.cos(theta), r * torch.sin(theta)


class Scatter(NamedTuple):
    dir: torch.Tensor          # (R, 3)
    pdf: torch.Tensor          # (R,)
    throughput: torch.Tensor   # (R, 3)
    is_specular: torch.Tensor  # (R,) bool


def eval_diffuse(albedo):
    return albedo / PI


def sample_diffuse(normal, albedo, r1, r2) -> Scatter:
    d = cosine_hemisphere(normal, r1, r2)
    cos_theta = torch.clamp(dot(normal, d), min=0.0)
    return Scatter(d, cos_theta / PI, albedo,
                   torch.zeros(r1.shape, dtype=torch.bool, device=r1.device))


def ggx_d(n_dot_h, a2):
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (PI * d * d)


def ggx_g(n_dot_v, n_dot_l, a2):
    g1v = 2.0 * n_dot_v / (n_dot_v + sqrt_rn(
        a2 + (1.0 - a2) * (n_dot_v * n_dot_v)))
    g1l = 2.0 * n_dot_l / (n_dot_l + sqrt_rn(
        a2 + (1.0 - a2) * (n_dot_l * n_dot_l)))
    return g1v * g1l


def fresnel_schlick(cos_theta, f0):
    p = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * pow5(p)[..., None]


def eval_ggx(n, v, l, roughness, f0):
    """The full microfacet BRDF value."""
    h = normalize(v + l)
    n_dot_v = torch.clamp(dot(n, v), min=1e-4)
    n_dot_l = torch.clamp(dot(n, l), min=1e-4)
    n_dot_h = torch.clamp(dot(n, h), min=1e-4)
    v_dot_h = torch.clamp(dot(v, h), min=1e-4)
    a2 = roughness * roughness
    d = ggx_d(n_dot_h, a2)
    g = ggx_g(n_dot_v, n_dot_l, a2)
    f = fresnel_schlick(v_dot_h, f0)
    return (d * g)[..., None] * f / (4.0 * n_dot_v * n_dot_l)[..., None]


def ggx_pdf(n, v, l, roughness):
    """pdf of sample_ggx, for the MIS weight of NEE."""
    h = normalize(v + l)
    n_dot_h = dot(n, h)
    v_dot_h = torch.clamp(dot(v, h), min=0.0)
    return (ggx_d(n_dot_h, roughness * roughness)
            * torch.clamp(n_dot_h, min=0.0)) \
        / (4.0 * torch.clamp(v_dot_h, min=1e-8))


def sample_ggx(n, v, roughness, f0, r1, r2) -> Scatter:
    """GGX D-distribution sampling."""
    a = roughness
    phi = 2.0 * PI * r1
    cos_theta = sqrt_rn(torch.clamp(
        (1.0 - r2) / (1.0 + (a * a - 1.0) * r2), min=0.0))
    sin_theta = sqrt_rn(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    h_local = torch.stack([sin_theta * torch.cos(phi),
                           sin_theta * torch.sin(phi), cos_theta], dim=-1)
    u, vv = build_onb(n)
    h = local_to_world(u, vv, n, h_local)
    l = reflect(-v, h)

    below = dot(n, l) <= 0.0

    n_dot_v = torch.clamp(dot(n, v), min=1e-4)
    n_dot_l = torch.clamp(dot(n, l), min=1e-4)
    n_dot_h = torch.clamp(dot(n, h), min=1e-4)
    v_dot_h = torch.clamp(dot(v, h), min=1e-4)

    a2 = a * a
    d = ggx_d(n_dot_h, a2)
    g = ggx_g(n_dot_v, n_dot_l, a2)
    f = fresnel_schlick(v_dot_h, f0)

    pdf = (d * n_dot_h) / (4.0 * v_dot_h)
    tp = torch.where((pdf > 1e-6)[..., None],
                     (g * v_dot_h / (n_dot_v * n_dot_h))[..., None] * f, 0.0)
    pdf = torch.where(below, 0.0, pdf)
    tp = torch.where(below[..., None], 0.0, tp)
    l = torch.where(below[..., None], 0.0, l)
    return Scatter(l, pdf, tp, roughness < 0.01)


def reflectance_dielectric(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * pow5(torch.clamp(1.0 - cosine, 0.0, 1.0))


def sample_dielectric(dir, normal, ior, albedo, r1) -> Scatter:
    """Schlick dielectric. `normal` arrives flipped against the ray (the
    caller flips it every bounce)."""
    front_face = dot(dir, normal) < 0.0
    ratio = torch.where(front_face, 1.0 / ior, ior)
    n = torch.where(front_face[..., None], normal, -normal)

    unit = normalize(dir)
    cos_theta = torch.clamp(dot(-unit, n), max=1.0)
    sin_theta = sqrt_rn(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))

    cannot_refract = ratio * sin_theta > 1.0
    do_reflect = cannot_refract \
        | (reflectance_dielectric(cos_theta, ratio) > r1)
    d = torch.where(do_reflect[..., None], reflect(unit, n),
                    refract(unit, n, ratio))
    return Scatter(d, torch.ones_like(r1), albedo,
                   torch.ones(r1.shape, dtype=torch.bool, device=r1.device))


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / torch.clamp(a2 + b2, min=1e-20)
