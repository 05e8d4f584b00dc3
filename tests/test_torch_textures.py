"""The port's texture path against the JAX package: decode, pack, pyramid,
the row and quad fetches, and the bilinear sampler.

- decode: the port reads PNG with zlib + numpy and restates Pillow's
  bilinear resize; the JAX package decodes with Pillow. Bit-equal on the
  fixtures' PNGs, on seeded random RGB/RGBA images, on hand-filtered
  PNGs of every colour type and row filter, and at every bit depth PNG
  allows, non-interlaced and Adam7 (tRNS ignored, as Pillow's
  convert("RGB") ignores it); the formats scene's four layers (JPEG and
  PNG) equal the JAX package's. Formats the port does not read raise
  NotImplementedError; bytes that are no image, and PNG at a bit depth its
  colour type does not allow, give both packages the 0.8 fill. JPEG has
  its own tests, tests/test_torch_jpeg.py.
- pack and pyramid: bit-equal for k = 1, 2 and 5 layers; at 5 layers
  5 * 128^2 > KRON_MAX_ROWS, so the mip aliases level 0 in both.
- fetch: the plain row fetch bit-equal to `pallas_fetch_t(interpret=True)`
  (the TPU kernel's one-hot body), the plain quad fetch to
  `pallas_fetch_kron(interpret=True)` (its Kronecker body).
- sampler: `sample_texture_v3` bit-equal on a plain level and a mip level.
"""

import io
import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tests import torch_scenes
from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.ops.dense_trace import \
    sample_texture_v3 as jax_sample
from webgpu_raytracer_tpu.ops.fetch import TexKron, build_tex_kron
from webgpu_raytracer_tpu.ops.pallas_dense import (pallas_fetch_kron,
                                                   pallas_fetch_t)
from webgpu_raytracer_tpu.utils import textures as jax_tex
from webgpu_raytracer_tpu_torch.ops.dense_trace import sample_texture_v3
from webgpu_raytracer_tpu_torch.ops.fetch import (TexLevel, device_pyramid,
                                                  fetch_quad_plain,
                                                  fetch_rows_plain,
                                                  gather_rows, kron_rows,
                                                  tex_level_from_np)
from webgpu_raytracer_tpu_torch.render.worldtris import (textures_from_jax,
                                                         world_tables_np)
from webgpu_raytracer_tpu_torch.utils import textures as port_tex

from tests.glb_fixture import (character_glb, exporter_quirks_glb,
                               textured_quad_glb)
from tests.torch_common import png_bytes

FIXTURES = {"textured_quad": textured_quad_glb, "character": character_glb,
            "exporter_quirks": exporter_quirks_glb}


def _fixture_pngs():
    out = []
    for name, glb in FIXTURES.items():
        world = NativeWorld("viewer", glb_data=glb())
        for i in range(world.texture_count()):
            out.append((f"{name}-{i}", world.texture(i)))
    return out


FIXTURE_PNGS = _fixture_pngs()


def _pil_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("case", range(len(FIXTURE_PNGS)),
                         ids=[c[0] for c in FIXTURE_PNGS])
def test_decode_fixture_textures_bit_equal(case):
    data = FIXTURE_PNGS[case][1]
    assert data.startswith(b"\x89PNG")
    np.testing.assert_array_equal(port_tex.decode_texture(data),
                                  jax_tex.decode_texture(data))


@pytest.mark.parametrize("shape", [(8, 8, 3), (8, 8, 4), (7, 13, 3),
                                   (7, 13, 4)])
def test_decode_random_png_bit_equal(shape):
    rs = np.random.default_rng(sum(shape))
    data = _pil_png(rs.integers(0, 256, shape, dtype=np.uint8))
    np.testing.assert_array_equal(port_tex.decode_texture(data),
                                  jax_tex.decode_texture(data))


@pytest.mark.parametrize("color_type", [0, 2, 3, 4, 6])
def test_decode_every_filter_and_colour_type(color_type):
    """Rows cycle through filters 0-4 on a smooth image (where the
    predictors matter) and the decode matches Pillow's, raw and resized."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    rs = np.random.default_rng(color_type)
    y, x = np.mgrid[0:11, 0:17]
    base = (x * 9 + y * 13)[..., None] + 40 * np.arange(channels)
    px = ((base + rs.integers(0, 6, base.shape)) % 256).astype(np.uint8)
    palette = None
    if color_type == 3:
        palette = rs.integers(0, 256, (256, 3))
    data = png_bytes(px, color_type, filters=(0, 1, 2, 3, 4),
                     palette=palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(port_tex.decode_png(data), want)
    np.testing.assert_array_equal(port_tex.decode_texture(data, 64),
                                  jax_tex.decode_texture(data, 64))


PNG_DEPTHS = [(ct, d) for ct, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                        (3, (1, 2, 4, 8)), (4, (8, 16)),
                                        (6, (8, 16)))
              for d in depths]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color_type,depth", PNG_DEPTHS)
def test_png_depths_and_adam7_match_pillow(color_type, depth, interlace):
    """Every (colour type, bit depth) pair PNG allows, non-interlaced and
    Adam7 (passes 1-7 of an 11x17 image, some rows ragged), rows through
    all five filters; smooth samples plus noise over the whole range, the
    palette shorter than the indices reach, 16-bit grey above 255."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    top = (1 << depth) - 1
    rs = np.random.default_rng(10 * color_type + depth + interlace)
    y, x = np.mgrid[0:11, 0:17]
    base = (x * 5 + y * 7)[..., None] * (1 + np.arange(channels))
    px = (base * max(1, top // 150) + rs.integers(0, max(2, top // 16),
                                                  base.shape)) % (top + 1)
    if color_type == 0 and depth == 16:
        px[0, :3, 0] = [250, 255, 0x100]
    palette = None
    if color_type == 3:
        palette = rs.integers(0, 256, (max(1, top - 2), 3))
    data = png_bytes(px, color_type, filters=(0, 1, 2, 3, 4),
                     palette=palette, depth=depth, interlace=interlace)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(port_tex.decode_png(data), want)
    np.testing.assert_array_equal(port_tex.decode_texture(data, 32),
                                  jax_tex.decode_texture(data, 32))


@pytest.mark.parametrize("width,height", [(1, 1), (2, 3), (5, 1), (9, 6)])
def test_adam7_empty_passes(width, height):
    """Images too small to fill all seven passes: a pass with no columns
    or no rows has no bytes at all, not even filter bytes."""
    rs = np.random.default_rng(width * 10 + height)
    px = rs.integers(0, 1 << 16, (height, width, 3))
    data = png_bytes(px, 2, filters=(4,), depth=16, interlace=1)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(port_tex.decode_png(data), want)
    np.testing.assert_array_equal(want, (px >> 8).astype(np.uint8))


def _with_chunk(png: bytes, tag: bytes, body: bytes) -> bytes:
    """`png` with one more chunk right after IHDR."""
    chunk = (struct.pack(">I", len(body)) + tag + body
             + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    return png[:33] + chunk + png[33:]


@pytest.mark.parametrize("color_type,depth,trns", [
    (0, 16, b"\x01\x00"), (0, 8, b"\x00\x10"), (2, 8, bytes(6)),
    (3, 4, b"\x00\x80")])
def test_png_transparency_is_ignored(color_type, depth, trns):
    """A tRNS chunk changes nothing in Pillow's convert("RGB")."""
    channels = {0: 1, 2: 3, 3: 1}[color_type]
    rs = np.random.default_rng(depth)
    px = rs.integers(0, 1 << depth, (6, 7, channels))
    palette = rs.integers(0, 256, (16, 3)) if color_type == 3 else None
    plain = png_bytes(px, color_type, palette=palette, depth=depth)
    data = _with_chunk(plain, b"tRNS", trns)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(port_tex.decode_png(data), want)
    np.testing.assert_array_equal(port_tex.decode_png(plain), want)


def test_formats_scene_textures_bit_equal():
    """tests/torch_scenes.py's texture formats scene (a 4:2:0 JPEG, a
    progressive JPEG, a 16-bit RGB Adam7 PNG and a 4-bit palette PNG): the
    port's four layers equal the JAX package's (Pillow) bit for bit, and
    its twin of 8-bit PNGs of the port's decodes gives the same layers."""
    glb = torch_scenes.formats_scene_glb()
    world = NativeWorld("viewer", glb_data=glb)
    assert world.texture_count() == 4
    port = port_tex.decode_world_textures(world)
    np.testing.assert_array_equal(port, jax_tex.decode_world_textures(world))
    assert not (port == 0.8).all(axis=(1, 2, 3)).any()
    twin = NativeWorld("viewer", glb_data=torch_scenes.formats_scene_glb(
        twin=True))
    np.testing.assert_array_equal(port_tex.decode_world_textures(twin), port)


@pytest.mark.parametrize("size", [(1500, 1100), (1024, 700)])
def test_resize_bilinear_matches_pillow(size):
    """Down- and up-sampling, and an axis left at its size."""
    rs = np.random.default_rng(size[0])
    img = rs.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((1024, 1024),
                                                  Image.BILINEAR))
    np.testing.assert_array_equal(port_tex.resize_bilinear(img, 1024), want)


def _sof_patched(marker: int, precision: int = 8) -> bytes:
    """A Pillow baseline JPEG whose SOF0 is relabelled `marker`, with
    sample precision `precision`."""
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    data = bytearray(buf.getvalue())
    pos = data.index(b"\xff\xc0")
    data[pos + 1] = marker
    data[pos + 4] = precision
    return bytes(data)


def _pil_bytes(fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


REFUSED = {"GIF": lambda: _pil_bytes("GIF"), "BMP": lambda: _pil_bytes("BMP"),
           "TIFF": lambda: _pil_bytes("TIFF"),
           "WebP": lambda: _pil_bytes("WEBP"),
           "arithmetic": lambda: _sof_patched(0xC9),
           "lossless": lambda: _sof_patched(0xC3),
           "12-bit": lambda: _sof_patched(0xC1, precision=12)}


@pytest.mark.parametrize("fmt", sorted(REFUSED))
def test_decode_refuses_what_it_does_not_read(fmt):
    """Formats glTF does not carry, and JPEG kinds the decoder does not
    read, raise naming what they are (PNG at every bit depth, Adam7 and
    baseline / progressive JPEG now decode)."""
    with pytest.raises(NotImplementedError, match=fmt):
        port_tex.decode_texture(REFUSED[fmt]())


@pytest.mark.parametrize("data", [b"not an image at all",
                                  _pil_png(np.zeros((4, 4, 3), np.uint8))[:45],
                                  png_bytes(np.zeros((4, 4, 3)), 2, depth=4)],
                         ids=["junk", "truncated_png", "rgb_at_4_bits"])
def test_decode_fallback_matches_jax(data):
    got = port_tex.decode_texture(data, 16)
    np.testing.assert_array_equal(got, jax_tex.decode_texture(data, 16))
    np.testing.assert_array_equal(got, np.full((16, 16, 3), 0.8, np.float32))


def test_chip_smoke_glb_matches_fixture():
    """tests/torch_scenes.py writes its textured quad without PIL: the same
    world tables and the same decoded texture as the fixture's."""
    ours = NativeWorld("viewer", glb_data=torch_scenes.textured_quad_glb())
    theirs = NativeWorld("viewer", glb_data=textured_quad_glb())
    for w in (ours, theirs):
        w.update_camera(32, 32)
    a, b = world_tables_np(ours), world_tables_np(theirs)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    tex = port_tex.decode_world_textures(ours)
    np.testing.assert_array_equal(tex, port_tex.decode_world_textures(theirs))
    assert (tex[0, :, :448] == [1, 0, 0]).all()
    assert (tex[0, :, 576:] == [0, 0, 1]).all()


@pytest.mark.parametrize("k", [1, 2, 5])
def test_pack_and_pyramid_bit_equal(k):
    rs = np.random.default_rng(k)
    tex = rs.random((k, 256, 256, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_tex.pack_quad_table(tex),
                                  jax_tex.pack_quad_table(tex))
    p0, p1 = port_tex.build_quad_pyramid(tex)
    j0, j1 = jax_tex.build_quad_pyramid(tex)
    np.testing.assert_array_equal(p0, j0)
    if k * port_tex.SECONDARY_MIP ** 2 > port_tex.KRON_MAX_ROWS:
        assert p1 is p0 and j1 is j0  # the mip rule: both alias level 0
    else:
        assert isinstance(j1, TexKron) and p1.shape == (k, 128, 128, 4)
        np.testing.assert_array_equal(p1, j1.flat)
    levels = textures_from_jax((j0, j1))
    mine = device_pyramid((p0, p1), "cpu")
    assert (levels[1] is levels[0]) == (mine[1] is mine[0])
    for a, b in zip(levels, mine):
        assert a.shape == b.shape and a.flat.dtype == torch.int32
        assert torch.equal(a.flat, b.flat)


@pytest.mark.parametrize("n", [40, 300, 1408])
def test_fetch_rows_plain_matches_pallas(n):
    rs = np.random.default_rng(n)
    table = rs.normal(size=(n, 40)).astype(np.float32)
    idx = np.concatenate([[-1, n, 0, n - 1, -5, n + 3],
                          rs.integers(0, n, 250)]).astype(np.int32)
    want = np.asarray(pallas_fetch_t(jnp.asarray(table), jnp.asarray(idx),
                                     interpret=True))
    got = fetch_rows_plain(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (40, idx.size) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        gather_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy(),
        want.T)


def test_fetch_quad_plain_matches_kron():
    """As tests/test_kron_fetch.py draws them: boundary words planted."""
    rs = np.random.default_rng(0)
    quad = jax_tex.pack_quad_table(
        rs.random((1, 128, 128, 3)).astype(np.float32))
    flat = quad.reshape(-1, 4)
    flat[0] = [0, (1 << 24) - 1, 0xFF0000, 0x0000FF]
    flat[1] = [0x010101, 0x808080, 0xFFFFFF, 1]
    kt = build_tex_kron(quad)
    n = flat.shape[0]
    idx = np.concatenate([np.arange(16), [127, 128, 129, n - 1, -1, n],
                          rs.integers(0, n, 4000)]).astype(np.int32)
    want = np.asarray(pallas_fetch_kron(jnp.asarray(kt.t2), jnp.asarray(idx),
                                        4, interpret=True)).T
    level = tex_level_from_np(quad, "cpu")
    got = fetch_quad_plain(level.flat, torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(kron_rows(level, torch.from_numpy(idx)),
                                  got.numpy())


@pytest.mark.parametrize("level", ["plain", "mip"])
def test_sampler_bit_equal(level):
    rs = np.random.default_rng(4)
    tex = rs.random((2, 256, 256, 3)).astype(np.float32)
    l0, l1 = jax_tex.build_quad_pyramid(tex)
    if level == "plain":
        jax_level, port_level = jnp.asarray(l0), tex_level_from_np(l0, "cpu")
    else:
        jax_level = TexKron(*(jnp.asarray(a) for a in l1))
        port_level = tex_level_from_np(l1.flat, "cpu")
    assert isinstance(port_level, TexLevel)
    n = 3000
    u = rs.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rs.uniform(-1.5, 2.5, n).astype(np.float32)
    u[:4] = [0.0, 1.0, -0.0, 0.5 / 256]
    tex_idx = rs.integers(-1, 2, n).astype(np.int32)
    a = jax_sample(jax_level, jnp.asarray(tex_idx), jnp.asarray(u),
                   jnp.asarray(v))
    b = sample_texture_v3(port_level, torch.from_numpy(tex_idx),
                          torch.from_numpy(u), torch.from_numpy(v))
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(cb.numpy(), np.asarray(ca))
    white = sample_texture_v3(None, torch.from_numpy(tex_idx),
                              torch.from_numpy(u), torch.from_numpy(v))
    assert all((c == 1.0).all() for c in white)
