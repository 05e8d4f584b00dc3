"""BSDF evaluation and sampling in component-SoA form.

The port of the JAX package's `ops/bsdf_v3.py`: Lambert, GGX, dielectric
and the power heuristic, operation for operation. Integer powers are
written as the products XLA's `integer_pow` lowers them to, so the f32
arithmetic is the same; sin, cos and sqrt may differ by ulps between ATen
and XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .v3 import V3, dot, normalize, sqrt_rn, where

PI = 3.141592653589793


def pow2(x):
    return x * x


def pow5(x):
    """x**5 as XLA's integer_pow computes it: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def reflect(i: V3, n: V3) -> V3:
    return i - n * (2.0 * dot(n, i))


def refract(i: V3, n: V3, eta) -> V3:
    """WGSL refract(): zero vector on total internal reflection."""
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = i * eta - n * (eta * cos_i + sqrt_rn(torch.clamp(k, min=0.0)))
    zero = torch.zeros_like(out.x)
    return where(k >= 0.0, out, V3(zero, zero, zero))


def build_onb(n: V3):
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    u = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    v = V3(b, sign + n.y * n.y * a, -n.y)
    return u, v


def local_to_world(u: V3, v: V3, w: V3, a: V3) -> V3:
    return u * a.x + v * a.y + w * a.z


def cosine_hemisphere(n: V3, r1, r2) -> V3:
    u, v = build_onb(n)
    phi = 2.0 * PI * r1
    cos_theta = sqrt_rn(torch.clamp(1.0 - r2, min=0.0))
    sin_theta = sqrt_rn(torch.clamp(r2, min=0.0))
    local = V3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
               cos_theta)
    return local_to_world(u, v, n, local)


def random_in_unit_disk(r1, r2):
    r = sqrt_rn(r1)
    theta = 2.0 * PI * r2
    return r * torch.cos(theta), r * torch.sin(theta)


class Scatter(NamedTuple):
    dir: V3
    pdf: torch.Tensor
    throughput: V3
    is_specular: torch.Tensor


def eval_diffuse(albedo: V3) -> V3:
    return albedo * (1.0 / PI)


def sample_diffuse(normal: V3, albedo: V3, r1, r2) -> Scatter:
    d = cosine_hemisphere(normal, r1, r2)
    cos_theta = torch.clamp(dot(normal, d), min=0.0)
    return Scatter(d, cos_theta / PI, albedo,
                   torch.zeros(r1.shape, dtype=torch.bool, device=r1.device))


def ggx_d(n_dot_h, a2):
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (PI * d * d)


def ggx_g(n_dot_v, n_dot_l, a2):
    g1v = 2.0 * n_dot_v / (n_dot_v + sqrt_rn(a2 + (1.0 - a2)
                                                 * pow2(n_dot_v)))
    g1l = 2.0 * n_dot_l / (n_dot_l + sqrt_rn(a2 + (1.0 - a2)
                                                 * pow2(n_dot_l)))
    return g1v * g1l


def fresnel_schlick(cos_theta, f0: V3) -> V3:
    p = pow5(torch.clamp(1.0 - cos_theta, 0.0, 1.0))
    return f0 + (V3(p, p, p) - f0 * p)  # f0 + (1 - f0) * p


def eval_ggx(n: V3, v: V3, l: V3, roughness, f0: V3) -> V3:
    h = normalize(v + l)
    n_dot_v = torch.clamp(dot(n, v), min=1e-4)
    n_dot_l = torch.clamp(dot(n, l), min=1e-4)
    n_dot_h = torch.clamp(dot(n, h), min=1e-4)
    v_dot_h = torch.clamp(dot(v, h), min=1e-4)
    a2 = roughness * roughness
    d = ggx_d(n_dot_h, a2)
    g = ggx_g(n_dot_v, n_dot_l, a2)
    f = fresnel_schlick(v_dot_h, f0)
    return f * (d * g / (4.0 * n_dot_v * n_dot_l))


def ggx_pdf(n: V3, v: V3, l: V3, roughness):
    h = normalize(v + l)
    n_dot_h = dot(n, h)
    v_dot_h = torch.clamp(dot(v, h), min=0.0)
    return (ggx_d(n_dot_h, roughness * roughness)
            * torch.clamp(n_dot_h, min=0.0)) / (
        4.0 * torch.clamp(v_dot_h, min=1e-8))


def sample_ggx(n: V3, v: V3, roughness, f0: V3, r1, r2) -> Scatter:
    a = roughness
    phi = 2.0 * PI * r1
    cos_theta = sqrt_rn(torch.clamp(
        (1.0 - r2) / (1.0 + (a * a - 1.0) * r2), min=0.0))
    sin_theta = sqrt_rn(torch.clamp(1.0 - pow2(cos_theta), min=0.0))
    h_local = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                 cos_theta)
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
    scale = torch.where(pdf > 1e-6, g * v_dot_h / (n_dot_v * n_dot_h), 0.0)
    tp = f * scale
    pdf = torch.where(below, 0.0, pdf)
    zero = torch.zeros_like(pdf)
    z3 = V3(zero, zero, zero)
    return Scatter(where(below, z3, l), pdf, where(below, z3, tp),
                   roughness < 0.01)


def reflectance_dielectric(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * pow5(torch.clamp(1.0 - cosine, 0.0, 1.0))


def sample_dielectric(dir: V3, normal: V3, ior, albedo: V3, r1) -> Scatter:
    front_face = dot(dir, normal) < 0.0
    ratio = torch.where(front_face, 1.0 / ior, ior)
    n = where(front_face, normal, -normal)

    unit = normalize(dir)
    cos_theta = torch.clamp(dot(-unit, n), max=1.0)
    sin_theta = sqrt_rn(torch.clamp(1.0 - pow2(cos_theta), min=0.0))

    cannot_refract = ratio * sin_theta > 1.0
    do_reflect = cannot_refract | (reflectance_dielectric(cos_theta, ratio)
                                   > r1)
    d = where(do_reflect, reflect(unit, n), refract(unit, n, ratio))
    return Scatter(d, torch.ones_like(r1), albedo,
                   torch.ones(r1.shape, dtype=torch.bool, device=r1.device))


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / torch.clamp(a2 + b2, min=1e-20)
