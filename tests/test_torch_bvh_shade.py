"""The BVH path's row-state bounce loop on the CPU (`ops/bvh_shade.py`,
`ops/trace.ray_color_rows`).

- `ray_color_rows` over the plain `bvh_shade_step` (given the scene's
  `ShadePack`, as `trace_pixels` gives it on the card) equals `ray_color`,
  the plain reference, bit for bit in radiance, rng words and ray count: on
  cornell, mixed, special, the textured quad GLB, the textured light
  GLB (a quad light with a textured base colour) and the texture formats
  GLB (base colour, metallic-roughness, normal map and emissive textures),
  at max_depth 0, 1, 2, 5 and 8.
- `pack_shade`: every field of every record holds its table row's bits
  (a light's world corners `_light_tri_world`'s), unused words are zero,
  and the records are 16-byte aligned rows of 16-byte quads.
- `bvh_shade_step` is lane-independent: permuting the lanes of every input
  permutes every output, bit for bit.
- A lane that does not walk (inactive, or a miss) advances its rng word by
  exactly six PCG draws, keeps its state and walks nothing more.
- `bvh_shade` on CPU tensors is `bvh_shade_step` and counts no launch.
- `trace_pixels` (now the rows loop) against JAX `trace_pixels` on the
  textured light scene, with `tests/test_torch_bvh.py`'s bounds;
  `tests/test_torch_bvh.py::test_trace_pixels_matches_jax` holds cornell
  and the textured quad.

The kernel, `csrc/bvh_shade.cu`, is held to `bvh_shade_step` on the card in
`tests/test_torch_cuda.py` and timed there by `chip_smoke.py`.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_scenes
from webgpu_raytracer_tpu.models.native import NativeWorld as JaxWorld
from webgpu_raytracer_tpu.ops import trace as jt
from webgpu_raytracer_tpu.render.resources import \
    build_device_scene as jax_scene
from webgpu_raytracer_tpu.utils import textures as jax_textures
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops import bvh_shade
from webgpu_raytracer_tpu_torch.ops import trace as pt
from webgpu_raytracer_tpu_torch.ops.rng import rand_pcg
from webgpu_raytracer_tpu_torch.ops.trace import _light_tri_world, _rows

RES = 16
# Preset, or GLB maker in the viewer scene.
SCENES = {"cornell": ("cornell", None), "mixed": ("mixed", None),
          "special": ("special", None),
          "textured": ("viewer", torch_scenes.textured_quad_glb),
          "textured_light": ("viewer", torch_scenes.textured_light_glb),
          "formats": ("viewer", torch_scenes.formats_scene_glb)}
DEPTHS = [0, 1, 2, 5, 8]

_cache = {}


def _scene(case):
    """(DeviceScene, camera) on the CPU at RES^2, built once a module."""
    if case not in _cache:
        name, glb = SCENES[case]
        _cache[case] = torch_scenes.bvh_scene(name, RES, RES, "cpu",
                                            glb() if glb else None)
    return _cache[case]


def _primaries(case):
    """(scene, ro, rd, rng) of frame 1's pinhole rays, rng past the lens
    draws."""
    scene, cam = _scene(case)
    args = torch_scenes.bvh_bounce_inputs(scene, cam, RES, RES, 0)
    return scene, args[3], args[4], args[2]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", sorted(SCENES))
def test_rows_loop_equals_ray_color(case, depth):
    scene, ro, rd, rng = _primaries(case)
    if SCENES[case][1] is not None:
        assert not scene.textures.is_floating_point()
    a = pt.ray_color(scene, ro, rd, rng, depth)
    b = pt.ray_color_rows(scene, ro, rd, rng, depth,
                          shade_pack=bvh_shade.pack_shade(scene))
    for name, x, y in zip(("radiance", "rng", "rays"), a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), (case, depth, name)
    if depth:
        assert float(b[0].mean()) > 0.0
        assert float(b[2]) > RES * RES
    else:
        assert float(b[0].abs().max()) == 0.0 and float(b[2]) == RES * RES


def _permuted(args, perm):
    """bvh_shade's arguments with every per-lane input's lanes permuted."""
    scene, state, rng, ro, rd, active, tri, inst, occ, depth, md = args

    def lanes(x):
        return None if x is None else x[perm]

    return (scene, state[:, perm], rng[perm], ro[perm], rd[perm],
            lanes(active), tri[perm], inst[perm], lanes(occ), depth, md)


@pytest.mark.parametrize("case,depth", [("cornell", 2), ("mixed", 1),
                                        ("textured_light", 2)])
def test_bvh_shade_step_is_lane_independent(case, depth):
    scene, cam = _scene(case)
    args = torch_scenes.bvh_bounce_inputs(scene, cam, RES, RES, depth)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(RES * RES))
    out, rng, nxt = bvh_shade.bvh_shade_step(*args)
    out_p, rng_p, nxt_p = bvh_shade.bvh_shade_step(*_permuted(args, perm))
    assert torch.equal(out[:, perm], out_p)
    assert torch.equal(rng[perm], rng_p)
    for x, y in zip(nxt, nxt_p):
        assert torch.equal(x[perm], y)
    assert bool(nxt.nee_lane.any()) and bool(nxt.do_next.any())


@pytest.mark.parametrize("case", ["cornell", "textured"])
def test_lanes_that_do_not_walk_draw_six_and_keep_their_state(case):
    """Every third lane made inactive and every fifth a miss, on bounce 1:
    those lanes' rng words advance by six draws, their throughput, pdf,
    specular flag and ray count stay, their radiance takes only the
    resolved pending NEE, and they walk neither ray."""
    scene, cam = _scene(case)
    args = list(torch_scenes.bvh_bounce_inputs(scene, cam, RES, RES, 1))
    R = RES * RES
    lane = torch.arange(R)
    off = (lane % 3 == 0) | (lane % 5 == 0)
    args[5] = args[5] & (lane % 3 != 0)
    args[7] = torch.where(lane % 5 == 0, -1, args[7]).to(torch.int32)
    state, rng, occ = args[1], args[2], args[8]
    out, rng_out, nxt = bvh_shade.bvh_shade_step(*args)
    want = rng
    for _ in range(6):
        want, _ = rand_pcg(want)
    assert torch.equal(rng_out, want)  # every lane draws six
    keep = [0, 1, 2, bvh_shade.PREV_PDF, bvh_shade.SPECULAR, bvh_shade.RAYS]
    assert torch.equal(out[keep][:, off], state[keep][:, off])
    assert torch.equal(out[3:6][:, off], bvh_shade.resolve(state, occ)[:, off])
    assert not bool(out[bvh_shade.PEND][off].any())
    assert not bool(nxt.do_next[off].any() | nxt.nee_lane[off].any())
    for x in (nxt.ro, nxt.rd, nxt.sro, nxt.srd):
        assert not bool(x[off].any())
    assert bool(nxt.nee_lane[~off].any())


def test_bvh_shade_on_cpu_is_the_plain_step():
    scene, cam = _scene("cornell")
    args = torch_scenes.bvh_bounce_inputs(scene, cam, RES, RES, 2)
    before = dict(kernels.launches)
    a = bvh_shade.bvh_shade(*args, pack=bvh_shade.pack_shade(args[0]))
    b = bvh_shade.bvh_shade_step(*args)
    assert kernels.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


def _bits(x):
    return x.contiguous().view(torch.int32) if x.is_floating_point() \
        else x.to(torch.int32)


@pytest.mark.parametrize("case", sorted(SCENES))
def test_shade_pack_fields_equal_table_rows(case):
    """Every field of the triangle, light and instance records holds its
    table rows' bits (a field of the vertices their three rows in vertex
    order); a light's corners are `_light_tri_world`'s; every word no
    field holds is zero."""
    scene, _ = _scene(case)
    pack = bvh_shade.pack_shade(scene)
    T, L = scene.tri_v.shape[0], scene.lights.shape[0]
    vidx = scene.tri_v.long()
    want = {"p": scene.pos[vidx].reshape(T, 9),
            "n": scene.nrm[vidx].reshape(T, 9),
            "uv": scene.uv[vidx].reshape(T, 6),
            "base_color": scene.tri_base_color, "mat": scene.tri_mat[:, None],
            "mrir": scene.tri_mrir, "tex": scene.tri_tex,
            "emissive": scene.tri_emissive}
    lref = scene.lights
    v0, v1, v2, lvidx = _light_tri_world(scene, lref[:, 1], lref[:, 0])
    lwant = {"v": torch.cat([v0, v1, v2], dim=1),
             "uv": scene.uv[lvidx].reshape(L, 6),
             "base_color": _rows(scene.tri_base_color, lref[:, 1]),
             "tex": _rows(scene.tri_tex, lref[:, 1])[:, :1]}
    iwant = {"inst_inv": scene.inst_inv[:, :3].reshape(-1, 12),
             "inst_tf": scene.inst_tf[:, :3].reshape(-1, 12)}
    for records, layout, table in (
            (pack.tris, bvh_shade.TRI_LAYOUT, want),
            (pack.lights, bvh_shade.LIGHT_LAYOUT, lwant),
            (pack.insts, bvh_shade.INST_LAYOUT, iwant)):
        words = bvh_shade.layout_words(layout)
        assert records.dtype == torch.int32 and set(words) == set(table)
        assert records.shape[1] == sum(width for _, width in layout)
        held = set()
        for name, (w, width) in words.items():
            assert torch.equal(records[:, w:w + width],
                               _bits(table[name])), (case, name)
            held.update(range(w, w + width))
        free = [w for w in range(records.shape[1]) if w not in held]
        assert not bool(records[:, free].any())
    assert pack.tris.shape[0] == T and pack.lights.shape[0] == L
    assert pack.textures is scene.textures
    assert pack.light_count == scene.light_count
    assert pack.textured == (not scene.textures.is_floating_point())
    assert pack.view is None  # the kernel's struct is built on CUDA only


def test_shade_pack_records_are_16_byte_aligned():
    """Each record (160, 80 and 96 bytes) is a whole number of 16-byte
    quads and every row starts 16-byte aligned."""
    for layout, words in ((bvh_shade.TRI_LAYOUT, 40),
                          (bvh_shade.LIGHT_LAYOUT, 20),
                          (bvh_shade.INST_LAYOUT, 24)):
        assert sum(width for _, width in layout) == words
        assert words % 4 == 0
    for case in ("cornell", "textured_light"):
        pack = bvh_shade.pack_shade(_scene(case)[0])
        for records in (pack.tris, pack.lights, pack.insts):
            assert records.is_contiguous()
            assert records.data_ptr() % 16 == 0
            assert records.stride(0) * 4 % 16 == 0


def _fresh(case):
    """A DeviceScene of its own (cloned tables), so that a test may edit it
    without touching the module's cached one."""
    scene, _ = _scene(case)
    return type(scene)(*(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in scene))


def test_scene_packs_are_rebuilt_for_an_edited_or_another_scene():
    """`trace.scene_packs` returns the same packs while a scene's tensors
    are unchanged; a write in place, a table swapped by `_replace` and a
    second scene each get packs of their own, built from their tables."""
    scene = _fresh("cornell")
    first = pt.scene_packs(scene)
    assert pt.scene_packs(scene) is first
    assert torch.equal(first[1].tris, bvh_shade.pack_shade(scene).tris)

    scene.tri_base_color[0, 0] += 0.25
    edited = pt.scene_packs(scene)
    assert edited is not first
    assert torch.equal(edited[1].tris, bvh_shade.pack_shade(scene).tris)
    assert not torch.equal(edited[1].tris, first[1].tris)
    assert pt.scene_packs(scene) is edited

    moved = scene._replace(pos=scene.pos + 1.0)
    swapped = pt.scene_packs(moved)
    assert swapped is not edited
    assert torch.equal(swapped[0].tris, pt.pack_walk(moved).tris)
    assert not torch.equal(swapped[0].tris, edited[0].tris)

    other = _fresh("mixed")
    packs = pt.scene_packs(other)
    assert packs is not swapped
    assert packs[1].tris.shape[0] == other.tri_v.shape[0]
    assert torch.equal(packs[1].tris, bvh_shade.pack_shade(other).tris)


def test_scene_packs_live_as_long_as_their_scene():
    """The cache holds no scene alive: dropping the scene drops its entry,
    and with it the packs."""
    import gc

    scene = _fresh("cornell")
    pt.scene_packs(scene)
    key = weakref.ref(scene.tri_v)
    assert key() in pt._packs
    del scene
    gc.collect()
    assert key() is None


_jax_trace = jax.jit(jt.trace_pixels, static_argnames=(
    "width", "height", "spp", "max_depth", "with_stats", "full_height",
    "total_spp"))


@pytest.mark.parametrize("frame", [1, 2])
def test_trace_pixels_matches_jax_textured_light(frame):
    """The rows loop through `trace_pixels` against JAX on the quad light
    with a textured base colour (NEE reads the light's texels), at
    tests/test_torch_bvh.py's bounds: >= 95% of lanes at rel < 1e-3, the
    means within 2%, the ray counts within 2%."""
    glb = torch_scenes.textured_light_glb()
    jw = JaxWorld("viewer", glb_data=glb)
    jw.update_camera(RES, RES)
    js = jax_scene(jw, textures=jax_textures.pack_quad_table(
        jax_textures.decode_world_textures(jw)))
    ps, cam = _scene("textured_light")
    a, rays_a = _jax_trace(js, jnp.asarray(cam.numpy()),
                           jnp.asarray(frame, jnp.int32),
                           jnp.zeros(2, jnp.float32), width=RES, height=RES,
                           spp=1, max_depth=3, with_stats=True)
    b, rays_b = pt.trace_pixels(ps, cam, frame, torch.zeros(2), RES, RES, 1,
                                3, with_stats=True)
    a, b = np.asarray(a), b.numpy()
    assert b.shape == a.shape and np.isfinite(b).all()
    assert b.mean() > 0.05
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    assert (rel < 1e-3).mean() >= 0.95
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3)
    assert abs(float(rays_a) - float(rays_b)) <= 0.02 * float(rays_a)
