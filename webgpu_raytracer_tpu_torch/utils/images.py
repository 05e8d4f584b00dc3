"""Image writers without Pillow: PNG and baseline JPEG, in numpy.

The JAX package encodes its recorder's PNG frames, the CLI's output and
the preview's JPEG stream through Pillow; the port does not depend on it.

- `png_rgb`: (H, W, 3) u8 -> PNG (8-bit RGB, filter 0 rows, zlib).
- `jpeg_rgb`: (H, W, 3) u8 -> baseline JFIF JPEG: YCbCr 4:4:4, the
  standard (Annex K) quantisation tables scaled for `quality` as libjpeg
  scales them, the DCT as 8x8 matrix products, and the standard Huffman
  tables. The run-length and Huffman stage is vectorised over all blocks:
  every code word is placed by a prefix sum, then the bits are packed at
  once, with no Python loop over blocks or coefficients.
- `encode_image`: PNG or JPEG by the output path's extension.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIG = b"\x89PNG\r\n\x1a\n"


def png_rgb(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> PNG bytes (filter 0 rows, zlib)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1)
    return (PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


# -- JPEG ---------------------------------------------------------------------

def _zigzag() -> np.ndarray:
    """ZIGZAG[k] = the row-major index of the k-th coefficient in zigzag
    order: anti-diagonals in turn, odd ones top to bottom."""
    cells = [(r, c) for r in range(8) for c in range(8)]
    cells.sort(key=lambda rc: (rc[0] + rc[1],
                               rc[0] if (rc[0] + rc[1]) % 2 else -rc[0]))
    return np.array([8 * r + c for r, c in cells])


ZIGZAG = _zigzag()

# Annex K.1, natural (row-major) order.
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

# Annex K.3: (code counts by length 1..16, symbols) for DC luma, DC chroma,
# AC luma, AC chroma.
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _huffman(table) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes (Annex C) of a (counts, symbols) table: code and
    length arrays indexed by symbol."""
    counts, symbols = table
    assert sum(counts) == len(symbols)
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = code
            lengths[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


# Index 0 for the luma component, 1 for the two chroma components.
_DC_CODES = [_huffman(t) for t in (_DC_LUMA, _DC_CHROMA)]
_AC_CODES = [_huffman(t) for t in (_AC_LUMA, _AC_CHROMA)]


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II D: D @ block @ D.T is the JPEG FDCT."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    d[0] /= np.sqrt(2)
    return d.astype(np.float32)


_DCT = _dct_matrix()
_DCT_T = np.ascontiguousarray(_DCT.T)


def quant_tables(quality: int) -> np.ndarray:
    """(2, 64) luma and chroma tables, natural order, scaled as libjpeg's
    `jpeg_set_quality` scales them (baseline: 1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = np.stack([_LUMA_Q, _CHROMA_Q])
    return np.clip((base * scale + 50) // 100, 1, 255)


def _size(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (the JPEG magnitude category; 0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The `size` low bits that follow a category: v, or for v < 0 its
    ones' complement."""
    v = v.astype(np.int64)
    return np.where(v < 0, v + (np.int64(1) << size) - 1, v)


def _scan_words(q: np.ndarray, comp_tab: np.ndarray):
    """Code words of the entropy-coded scan, in order: (values, lengths).

    q (N, 64) i32 quantised coefficients in zigzag order, the blocks in
    scan order; comp_tab (N,) the Huffman table of each block (0 luma, 1
    chroma). A block is its DC word, then per non-zero AC coefficient
    a ZRL word for each full 16 zeros before it and its own word, then
    EOB unless the block's last coefficient is non-zero. Each word is
    placed at its index by prefix sums over the per-block counts."""
    n = q.shape[0]
    dc_code = np.stack([c for c, _ in _DC_CODES])
    dc_len = np.stack([l for _, l in _DC_CODES])
    ac_code = np.stack([c for c, _ in _AC_CODES])
    ac_len = np.stack([l for _, l in _AC_CODES])

    # DC: the difference from the previous block of the same component.
    dc = q[:, 0].astype(np.int64).reshape(-1, 3)
    diff = np.diff(dc, axis=0, prepend=0).reshape(-1)
    s = _size(diff)
    dc_val = (dc_code[comp_tab, s] << s) | _amplitude(diff, s)
    dc_bits = dc_len[comp_tab, s] + s

    # AC: the non-zero coefficients in scan order, their zero runs.
    nz = q[:, 1:] != 0
    blk, k = np.nonzero(nz)
    k = k + 1
    prev = np.zeros_like(k)
    same = np.zeros(k.shape, bool)
    same[1:] = blk[1:] == blk[:-1]
    prev[1:] = np.where(same[1:], k[:-1], 0)
    run = k - prev - 1
    zrl = run >> 4
    v = q[blk, k].astype(np.int64)
    s = _size(v)
    tab = comp_tab[blk]
    sym = ((run & 15) << 4) | s
    ac_val = (ac_code[tab, sym] << s) | _amplitude(v, s)
    ac_bits = ac_len[tab, sym] + s

    last = np.where(nz.any(1), 63 - np.argmax(nz[:, ::-1], axis=1), 0)
    eob = last < 63

    words_per_nz = zrl + 1
    per_block = (1 + eob.astype(np.int64)
                 + np.bincount(blk, weights=words_per_nz, minlength=n)
                 .astype(np.int64))
    start = np.cumsum(per_block) - per_block
    total = int(per_block.sum())
    before = np.cumsum(words_per_nz) - words_per_nz  # over all blocks
    first = np.searchsorted(blk, blk)  # first non-zero of each one's block
    pos = start[blk] + 1 + (before - before[first]) + zrl

    val = np.empty(total, np.int64)
    bits = np.empty(total, np.int64)
    val[start], bits[start] = dc_val, dc_bits
    val[pos], bits[pos] = ac_val, ac_bits
    n_zrl = int(zrl.sum())
    if n_zrl:
        zrl_before = np.cumsum(zrl) - zrl
        zpos = (np.repeat(pos - zrl, zrl)
                + np.arange(n_zrl) - np.repeat(zrl_before, zrl))
        ztab = np.repeat(tab, zrl)
        val[zpos], bits[zpos] = ac_code[ztab, 0xF0], ac_len[ztab, 0xF0]
    epos = (start + per_block - 1)[eob]
    val[epos], bits[epos] = ac_code[comp_tab[eob], 0], ac_len[comp_tab[eob], 0]
    return val, bits


def _pack(val: np.ndarray, bits: np.ndarray) -> bytes:
    """Concatenate code words MSB first, pad with 1 bits, stuff a 0 after
    every 0xFF byte."""
    total = int(bits.sum())
    word = np.repeat(np.arange(val.size), bits)
    within = np.arange(total) - np.repeat(np.cumsum(bits) - bits, bits)
    stream = ((val[word] >> (bits[word] - 1 - within)) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-total % 8, np.uint8)])
    data = np.packbits(stream)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def jpeg_rgb(img: np.ndarray, quality: int = 85) -> bytes:
    """(H, W, 3) u8 -> baseline JFIF JPEG bytes (YCbCr 4:4:4)."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    px = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)),
                mode="edge").astype(np.float32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    # JFIF YCbCr, level-shifted by -128 (the chroma offsets cancel it).
    # Elementwise: a (N, 3) @ (3, 3) product is slow in threaded BLAS.
    planes = np.stack([0.299 * r + 0.587 * g + 0.114 * b - 128.0,
                       -0.168736 * r - 0.331264 * g + 0.5 * b,
                       0.5 * r - 0.418688 * g - 0.081312 * b])
    # (rows, cols, component, 8, 8): blocks in scan order, Y Cb Cr each.
    blocks = np.ascontiguousarray(
        planes.reshape(3, ph // 8, 8, pw // 8, 8).transpose(1, 3, 0, 2, 4))
    # Many 8x8 products, not one (N, 64) x (64, 64) GEMM: threaded BLAS
    # was 10x slower on that shape on a loaded host.
    coef = (_DCT @ blocks @ _DCT_T).reshape(-1, 64)[:, ZIGZAG]
    qt = quant_tables(quality)
    comp_tab = np.tile(np.array([0, 1, 1]), coef.shape[0] // 3)
    q = np.round(coef / qt[:, ZIGZAG][comp_tab]).astype(np.int32)

    header = b"\xff\xd8" + _segment(
        0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    header += _segment(0xFFDB, b"".join(
        bytes([t]) + qt[t][ZIGZAG].astype(np.uint8).tobytes()
        for t in range(2)))
    header += _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]))
    header += _segment(0xFFC4, b"".join(
        bytes([cls << 4 | tid]) + bytes(counts) + bytes(symbols)
        for cls, tid, (counts, symbols) in (
            (0, 0, _DC_LUMA), (0, 1, _DC_CHROMA), (1, 0, _AC_LUMA),
            (1, 1, _AC_CHROMA))))
    header += _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return header + _pack(*_scan_words(q, comp_tab)) + b"\xff\xd9"


def image_format(path: str) -> str:
    """"png" for a `.png` path, "jpeg" for `.jpg` / `.jpeg`; any other
    extension raises ValueError."""
    ext = path.lower().rsplit(".", 1)[-1] if "." in path else ""
    if ext == "png":
        return "png"
    if ext in ("jpg", "jpeg"):
        return "jpeg"
    raise ValueError(f"{path}: the port writes .png, .jpg or .jpeg images")


def encode_image(img: np.ndarray, path: str) -> bytes:
    """PNG or JPEG (quality 85) by `path`'s extension (`image_format`)."""
    return png_rgb(img) if image_format(path) == "png" else jpeg_rgb(img)
