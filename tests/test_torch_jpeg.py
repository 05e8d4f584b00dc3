"""The port's JPEG decoder (`utils/jpeg.py`) against Pillow 12.1.0 with
libjpeg-turbo 3.1.3, the JAX package's decoder, bit for bit (tolerance 0).

- Pillow's own JPEGs of seeded smooth-plus-noise images: sizes 1x1 to
  129x67, 4:4:4 / 4:2:2 / 4:2:0, baseline, optimised and progressive,
  restart markers by blocks and by rows, quality 50 / 90 / 100, covered by
  a rotation through the matrix rather than its full product; greyscale,
  CMYK and Adobe RGB; and the committed fixtures of the texture formats
  scene (`tests/torch_scenes.py`), which must also regenerate byte for
  byte.
- Streams Pillow's encoder does not write, from
  `tests.torch_common.jpeg_from_coefficients` (random coefficients, any
  sampling factors): h1v2 fancy upsampling, widths where turbo falls
  back to replication, integral ratios (int_upsample), mixed factors,
  YCCK / CMYK / RGB colour spaces by marker and by component id, 16-bit
  quantisation tables, restart intervals, one scan per component, fill
  bytes and segments Pillow does not write, and coefficients large enough
  that libjpeg-turbo's SIMD IDCT wraps and saturates 16-bit words.
- Pillow's CMYK -> RGB conversion over all 65,536 (channel, K) pairs.
- `decode_texture` against the JAX package's: the same textures, the 0.8
  fill for damaged data in both, and the one reference behaviour the port
  does not restate: corrupt entropy data that libjpeg decodes into a
  partial image with a warning gives the port the fill.
"""

import io
import itertools
import json
import os

import numpy as np
import pytest
from PIL import Image

from tools import torch_texture_fixtures as fixtures
from webgpu_raytracer_tpu.utils import textures as jax_tex
from webgpu_raytracer_tpu_torch.utils import jpeg
from webgpu_raytracer_tpu_torch.utils import textures as port_tex

from tests.torch_common import jpeg_from_coefficients


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_jpeg(h, w, seed, mode="RGB", **options) -> bytes:
    channels = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    px = fixtures.source_pixels(w, h, channels, seed)
    img = Image.fromarray(px[..., 0] if channels == 1 else px, mode)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **options)
    return buf.getvalue()


SIZES = [(1, 1), (7, 13), (37, 53), (67, 129)]  # (h, w)
SUBSAMPLING = ["4:4:4", "4:2:2", "4:2:0"]
KINDS = [{}, {"optimize": True}, {"progressive": True}]
RESTARTS = [{}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}]
QUALITY = [50, 90, 100]


def _matrix():
    """Every (size, subsampling) pair once, the kind, restart and quality
    rotating so that each value meets several of the others."""
    out = []
    for i, (size, sub) in enumerate(itertools.product(SIZES, SUBSAMPLING)):
        out.append((size, sub, KINDS[i % 3], RESTARTS[(i // 3) % 3],
                    QUALITY[(i + i // 3) % 3]))
    return out


MATRIX = _matrix()


@pytest.mark.parametrize("case", range(len(MATRIX)),
                         ids=[f"{h}x{w}-{s}-{sorted(k)}-{sorted(r)}-q{q}"
                              for (h, w), s, k, r, q in MATRIX])
def test_decode_matches_pillow(case):
    (h, w), sub, kind, restart, quality = MATRIX[case]
    data = _pil_jpeg(h, w, case, quality=quality, subsampling=sub, **kind,
                     **restart)
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("mode,size,options", [
    ("L", (1, 1), {}), ("L", (37, 53), {"progressive": True}),
    ("L", (67, 129), {"quality": 100, "restart_marker_rows": 1}),
    ("CMYK", (7, 13), {}), ("CMYK", (37, 53), {"progressive": True}),
    ("RGB", (37, 53), {"keep_rgb": True}),
    ("RGB", (67, 129), {"keep_rgb": True, "progressive": True}),
], ids=lambda v: str(v).replace(" ", ""))
def test_grey_cmyk_and_rgb_match_pillow(mode, size, options):
    data = _pil_jpeg(*size, 7, mode=mode, **options)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


with open(os.path.join(fixtures.DIR, "digests.json")) as _f:
    DIGESTS = json.load(_f)


@pytest.mark.parametrize("name", sorted(fixtures.FIXTURES))
def test_fixture_regenerates_and_decodes(name):
    """The committed file is what Pillow writes today, its digest what
    Pillow decodes, and the port decodes to the same bytes."""
    with open(os.path.join(fixtures.DIR, f"{name}.jpg"), "rb") as f:
        data = f.read()
    assert data == fixtures.fixture_bytes(name)
    assert DIGESTS[f"{name}.jpg"] == fixtures.reference_digest(data)
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil(data))
    np.testing.assert_array_equal(port_tex.decode_texture(data, 64),
                                  jax_tex.decode_texture(data, 64))


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _adobe(transform: int) -> bytes:
    return _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes(
        [transform]))


# name -> (width, height, sampling, jpeg_from_coefficients options)
STREAMS = {
    "h1v2": (37, 29, [(1, 2), (1, 1), (1, 1)], {}),
    "h2v2_width3": (3, 29, [(2, 2), (1, 1), (1, 1)], {}),
    "h2v2_width5": (5, 9, [(2, 2), (1, 1), (1, 1)], {}),
    "h2v1_width4": (4, 9, [(2, 1), (1, 1), (1, 1)], {}),
    "h4v1": (45, 17, [(4, 1), (1, 1), (1, 1)], {}),
    "h3v1": (45, 17, [(3, 1), (1, 1), (1, 1)], {}),
    "mixed": (45, 37, [(2, 2), (1, 2), (2, 1)], {}),
    "grey_2x2": (45, 37, [(2, 2)], {}),
    "ycck": (21, 19, [(2, 2), (1, 1), (1, 1), (2, 2)],
             {"app": _adobe(2)}),
    "cmyk_adobe": (21, 19, [(1, 1)] * 4, {"app": _adobe(0)}),
    "cmyk_plain": (21, 19, [(1, 1)] * 4, {}),
    "rgb_ids": (21, 19, [(1, 1)] * 3, {"ids": [82, 71, 66]}),
    "rgb_ids_jfif": (21, 19, [(1, 1)] * 3, {"ids": [82, 71, 66],
                                            "app": JFIF}),
    "adobe_rgb": (21, 19, [(1, 1)] * 3, {"app": _adobe(0)}),
    "adobe_ycc": (21, 19, [(2, 1), (1, 1), (1, 1)], {"app": _adobe(1)}),
    "quant16_sof1": (33, 19, [(2, 2), (1, 1), (1, 1)], {"quant_bits": 16}),
    "restart": (33, 19, [(2, 2), (1, 1), (1, 1)], {"restart": 2}),
    "separate_scans": (33, 19, [(2, 2), (1, 1), (1, 2)],
                       {"separate_scans": True, "restart": 3}),
    "large_coefficients": (33, 19, [(1, 1)] * 3,
                           {"quant_bits": 16, "ac_scale": 300.0,
                            "dc_spread": 1000}),
    "large_dc_only_rows": (33, 19, [(1, 1)] * 3,
                           {"quant_bits": 16, "ac_scale": 0.05,
                            "dc_spread": 1000}),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_pillow_does_not_write(name):
    w, h, sampling, options = STREAMS[name]
    for seed in range(2):
        data = jpeg_from_coefficients(w, h, sampling, seed, **options)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data),
                                      err_msg=f"seed {seed}")


def test_fill_bytes_comments_and_trailing_data():
    """0xFF fill bytes before markers, COM and APPn segments between
    tables, and bytes after EOI, as libjpeg reads them."""
    data = _baseline(5)
    dqt = data.index(b"\xff\xdb")
    sos = data.index(b"\xff\xda")
    data = (data[:dqt] + _segment(0xFE, b"a comment") + b"\xff\xff"
            + data[dqt:sos] + _segment(0xE5, b"APP5") + b"\xff\xff\xff"
            + data[sos:] + b"trailing")
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


def test_cmyk_conversion_matches_pillow():
    """Pillow's cmyk2rgb on every (channel value, K) pair; the decoder
    takes the samples as stored (inverted, rawmode "CMYK;I")."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, 255 - c, (c * 7) % 256, k], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("CMYK", (256, 256), cmyk.tobytes())
                      .convert("RGB"))
    got = jpeg._cmyk_rgb([255 - cmyk[..., i] for i in range(4)])
    np.testing.assert_array_equal(got, want)


def _baseline(seed=1) -> bytes:
    return _pil_jpeg(40, 56, seed, quality=90)


def _scan_start(data: bytes) -> int:
    sos = data.index(b"\xff\xda")
    return sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")


def _without(data: bytes, marker: int) -> bytes:
    """`data` with every segment of `marker` before the first scan
    removed."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != marker:
            out += data[pos:end]
        pos = end
    return bytes(out) + data[pos:]


def _bogus_dht(data: bytes) -> bytes:
    """Three codes of length 1: jpeg_make_d_derived_tbl refuses it."""
    pos = data.index(b"\xff\xc4")
    return data[:pos + 5] + bytes([3]) + data[pos + 6:]


DAMAGED = {
    "truncated_in_scan": lambda d: d[:(_scan_start(d) + len(d)) // 2],
    "no_eoi": lambda d: d[:-2],
    "bogus_huffman_table": _bogus_dht,
    "no_quantisation_table": lambda d: _without(d, 0xDB),
    "restart_out_of_sequence": lambda d: d.replace(b"\xff\xd1", b"\xff\xd3"),
}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_jpeg_gives_the_fill_in_both(name):
    base = (_pil_jpeg(40, 56, 2, restart_marker_blocks=2)
            if name == "restart_out_of_sequence" else _baseline())
    data = DAMAGED[name](base)
    assert data != base
    fill = np.full((16, 16, 3), 0.8, np.float32)
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(port_tex.decode_texture(data, 16), fill)
    if name == "restart_out_of_sequence":
        return  # libjpeg resyncs with a warning: a reference behaviour
    np.testing.assert_array_equal(jax_tex.decode_texture(data, 16), fill)


def test_missing_huffman_tables_take_the_defaults():
    """libjpeg-turbo puts its default tables in slots 0 and 1 of a
    sequential file that defines none (Motion-JPEG); a progressive file
    without them does not open."""
    data = _without(_baseline(), 0xC4)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))
    prog = _without(_pil_jpeg(40, 56, 3, progressive=True), 0xC4)
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(prog)
    np.testing.assert_array_equal(port_tex.decode_texture(prog, 16),
                                  jax_tex.decode_texture(prog, 16))


def test_corrupt_entropy_data_is_a_reference_behaviour():
    """A run of 64 one bits in the middle of the scan is no Huffman code:
    libjpeg warns and goes on, so the JAX package gets a partial image;
    the port gives the 0.8 fill (ROADMAP queue 3)."""
    data = _baseline()
    mid = (_scan_start(data) + len(data)) // 2
    data = data[:mid] + b"\xff\x00" * 8 + data[mid:]
    with pytest.raises(ValueError, match="bad Huffman code"):
        jpeg.decode_jpeg(data)
    port = port_tex.decode_texture(data, 16)
    assert (port == 0.8).all()
    assert not (jax_tex.decode_texture(data, 16) == 0.8).all()


def test_incomplete_progression_raises():
    """A progressive file whose scans stop before AC 1-9 are complete is
    block-smoothed by libjpeg; the port refuses it by name."""
    data = _pil_jpeg(40, 56, 4, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    with pytest.raises(NotImplementedError, match="block smoothing"):
        jpeg.decode_jpeg(data[:sos[5]] + b"\xff\xd9")
