"""PCG and BSDF math of the port against the JAX package.

rng: bit-equal states and f32 draws (the port computes u32 words in int64).
bsdf: allclose at rtol 1e-5, because sin/cos/sqrt/pow may differ by ulps
between XLA and ATen; the f32 arithmetic order is otherwise the same.
Inputs are drawn where that tolerance is meaningful: the view direction in
the normal's hemisphere and roughness in [0.3, 1). The GGX D term grows
like 1/roughness**4 at its peak, so below that an ulp of sin/cos in a
sampled half-vector moves the sampled pdf by more than 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webgpu_raytracer_tpu.ops import bsdf_v3 as jb
from webgpu_raytracer_tpu.ops import rng as jrng
from webgpu_raytracer_tpu.ops.v3 import V3 as JV3
from webgpu_raytracer_tpu_torch.ops import bsdf_v3 as tb
from webgpu_raytracer_tpu_torch.ops import rng as trng
from webgpu_raytracer_tpu_torch.ops.v3 import V3 as TV3


@pytest.mark.parametrize("frame", [0, 1, 7, 123456789])
def test_pcg_bit_identical(frame):
    rs = np.random.default_rng(frame)
    pix = rs.integers(0, 2**32, size=100_000, dtype=np.uint64) \
        .astype(np.uint32)
    js = jrng.init_rng(jnp.asarray(pix), jnp.uint32(frame))
    ts = trng.init_rng(torch.from_numpy(pix.astype(np.int64)), frame)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for _ in range(6):
        js, ju = jrng.rand_pcg(js)
        ts, tu = trng.rand_pcg(ts)
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).astype(np.int64))
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def _vec(rs, n, unit=False):
    v = rs.normal(size=(3, n)).astype(np.float32)
    if unit:
        v = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    return v


def _both(v):
    return (JV3(*(jnp.asarray(c) for c in v)),
            TV3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in v)))


def _close(t, j, what):
    if isinstance(t, TV3):
        for a, b in zip(t, j):
            _close(a, b, what)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6, err_msg=what)


CASES = ["diffuse", "ggx_eval", "ggx_pdf", "ggx_sample", "dielectric",
         "unit_disk", "power_heuristic"]


@pytest.mark.parametrize("case", CASES)
def test_bsdf_matches_jax(case):
    rs = np.random.default_rng(CASES.index(case))
    n = 4096
    nv, vv = _vec(rs, n, unit=True), _vec(rs, n, unit=True)
    vv = vv * np.where((nv * vv).sum(0) < 0.0, -1.0, 1.0).astype(np.float32)
    nj, nt = _both(nv)
    vj, vt = _both(vv)
    aj, at = _both(rs.uniform(0.05, 1.0, size=(3, n)).astype(np.float32))
    r1 = rs.uniform(size=n).astype(np.float32)
    r2 = rs.uniform(size=n).astype(np.float32)
    rough = rs.uniform(0.3, 1.0, size=n).astype(np.float32)
    r1j, r2j, rj = jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(rough)
    r1t, r2t, rt = (torch.from_numpy(x) for x in (r1, r2, rough))
    if case == "diffuse":
        sj = jb.sample_diffuse(nj, aj, r1j, r2j)
        st = tb.sample_diffuse(nt, at, r1t, r2t)
        _close(st.dir, sj.dir, "dir")
        _close(st.pdf, sj.pdf, "pdf")
        _close(tb.eval_diffuse(at), jb.eval_diffuse(aj), "eval")
    elif case == "ggx_eval":
        _close(tb.eval_ggx(nt, vt, at, rt, at), jb.eval_ggx(nj, vj, aj, rj,
                                                            aj), "eval")
    elif case == "ggx_pdf":
        _close(tb.ggx_pdf(nt, vt, at, rt), jb.ggx_pdf(nj, vj, aj, rj), "pdf")
    elif case == "ggx_sample":
        sj = jb.sample_ggx(nj, vj, rj, aj, r1j, r2j)
        st = tb.sample_ggx(nt, vt, rt, at, r1t, r2t)
        _close(st.dir, sj.dir, "dir")
        _close(st.pdf, sj.pdf, "pdf")
        _close(st.throughput, sj.throughput, "throughput")
        np.testing.assert_array_equal(st.is_specular.numpy(),
                                      np.asarray(sj.is_specular))
    elif case == "dielectric":
        ior = rs.uniform(1.1, 2.4, size=n).astype(np.float32)
        sj = jb.sample_dielectric(vj, nj, jnp.asarray(ior), aj, r1j)
        st = tb.sample_dielectric(vt, nt, torch.from_numpy(ior), at, r1t)
        _close(st.dir, sj.dir, "dir")
    elif case == "unit_disk":
        for a, b in zip(tb.random_in_unit_disk(r1t, r2t),
                        jb.random_in_unit_disk(r1j, r2j)):
            _close(a, b, "disk")
    else:
        _close(tb.power_heuristic(r1t, r2t), jb.power_heuristic(r1j, r2j),
               "power")
