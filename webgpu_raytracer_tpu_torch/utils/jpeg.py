"""JPEG decoding without Pillow: baseline, extended and progressive Huffman
JPEG to (H, W, 3) u8 RGB, bit-equal to Pillow's `convert("RGB")`.

The JAX package opens textures through Pillow, which decodes JPEG with
libjpeg-turbo; the port does not depend on Pillow, so this module restates
what that pair does to the bytes:

- markers as libjpeg's `jdmarker.c` reads them (SOI, APPn with the JFIF
  and Adobe markers, COM, DQT with 8- and 16-bit tables, DHT, SOF0/1/2,
  DRI, SOS, RSTn, EOI; fill bytes before a marker, 0xFF00 stuffing);
  libjpeg-turbo's default Huffman tables stand in for DC/AC tables 0 and
  1 of a sequential file that defines none (Motion-JPEG's convention);
- Huffman decoding of sequential and progressive scans (`jdhuff.c`,
  `jdphuff.c`), restart intervals included. This is the only loop per
  symbol: a 16-bit peek table over 48-bit windows of the scan's bytes;
- dequantisation and the integer IDCT `jpeg_idct_islow` (`jidctint.c`,
  CONST_BITS 13, PASS1_BITS 2) over every block at once, as the x86 SIMD
  version that Pillow's libjpeg-turbo runs computes it: 16-bit words for
  the dequantised coefficients and four of the sums, pass 1 saturated to
  16 bits, its shortcut for blocks with nothing in rows 1-7, and the
  output clamped. The C version differs (32-bit sums, the output through
  a range-limit table that wraps at 0x3FF) only on coefficients that
  overflow those words, which no encoder of 8-bit images writes;
- chroma upsampling as libjpeg-turbo's `jdsample.c` does it with fancy
  upsampling on (Pillow's default): the triangle filters h2v1, h2v2 and
  h1v2 where turbo picks them, replication otherwise;
- colour conversion with `jdcolor.c`'s fixed-point tables (YCbCr, RGB,
  YCCK), the colour space chosen as `default_decompress_parms` chooses it;
  then Pillow's own step to RGB: grey replicated, and CMYK (which Pillow
  always reads inverted, rawmode "CMYK;I") through its `cmyk2rgb`.

`decode_jpeg` raises NotImplementedError, naming the kind, for what it
does not read (lossless, hierarchical and arithmetic-coded JPEG, 12-bit
samples, DNL, and a progressive file whose scans leave low AC bits unset,
which libjpeg would block-smooth), and ValueError for damaged data.
Where libjpeg only warns and goes on (entropy data that runs short or
holds a bad code, a restart marker out of sequence), this decoder raises
ValueError too: the texture then takes the 0.8 fill where the JAX package
gets a partial image.
"""

from __future__ import annotations

import array
import re
import struct

import numpy as np

from .images import ZIGZAG

_SOF_KINDS = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)",
    0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)",
    0xCF: "arithmetic-coded JPEG (SOF15)",
}

# libjpeg-turbo's jstdhuff.c (the Annex K.3 tables): (counts by length
# 1..16, symbols), luma then chroma, for DC and for AC.
_STD_DC = (
    (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
     bytes(range(12))),
    (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
     bytes(range(12))))
_STD_AC = (
    (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")))

_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")  # the next marker
_RST = re.compile(rb"\xff+([\xd0-\xd7])")
_STUFFED = re.compile(rb"\xff+\x00")
_PAD = 16  # zero bytes after a scan's data: peeks past its end read zeros


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None      # latched at the component's first scan
        self.coef = None       # blocks of 64 zigzag coefficients, flat
        self.bits = [-1] * 64  # libjpeg's coef_bits (progressive)


class _Frame:
    def __init__(self, marker: int, body: bytes):
        if len(body) < 6:
            raise ValueError("JPEG: SOF segment too short")
        precision, self.height, self.width, n = struct.unpack(
            ">BHHB", body[:6])
        if precision != 8:
            raise NotImplementedError(
                f"{precision}-bit JPEG: the decoder reads 8-bit samples")
        if self.height == 0:
            raise NotImplementedError(
                "JPEG whose height comes in a DNL marker")
        if self.width == 0 or n not in (1, 3, 4) or len(body) != 6 + 3 * n:
            raise ValueError("JPEG: bad SOF segment")
        self.progressive = marker == 0xC2
        self.comps = []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise ValueError("JPEG: bad sampling factors or table")
            self.comps.append(_Component(cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcu_cols = -(-self.width // (8 * self.hmax))
        self.mcu_rows = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            # Blocks holding samples, and the MCU-padded array of them.
            c.bw = -(-self.width * c.h // (8 * self.hmax))
            c.bh = -(-self.height * c.v // (8 * self.vmax))
            c.coef = array.array("i", bytes(
                4 * 64 * self.mcu_cols * c.h * self.mcu_rows * c.v))
            c.stride = self.mcu_cols * c.h  # blocks a row of the array


def _codes(counts: bytes, symbols: bytes, is_dc: bool) -> list:
    """The canonical codes of a Huffman table as (code, length, symbol),
    after libjpeg's checks (jpeg_make_d_derived_tbl): no code may be all
    ones, and a DC symbol is a size of at most 15."""
    out = []
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if is_dc and symbols[k] > 15:
                raise ValueError("JPEG: bad Huffman table")
            out.append((code, length, symbols[k]))
            code += 1
            k += 1
        if k and code >= 1 << length:
            raise ValueError("JPEG: bad Huffman table")
        code <<= 1
    return out


def _huffman_lut(counts: bytes, symbols: bytes, is_dc: bool) -> list:
    """A 65536-entry peek table for one Huffman table. Entry for the 16
    bits at the read position:
    - 0: no code of at most 16 bits starts there (a bad code);
    - (value << 9) | (run << 5) | n with n in 1..16: the code and its
      s = symbol & 15 appended bits take n bits, `value` is the extended
      coefficient (0 when s = 0, and for a DC table run is 0);
    - (length << 13) | (symbol << 5): n = 0, the appended bits do not fit
      in the peek; the caller reads them after `length` code bits.
    """
    lut = np.zeros(65536, np.int64)
    for code, length, sym in _codes(counts, symbols, is_dc):
        s, run = sym & 15, sym >> 4
        lo = code << (16 - length)
        span = 1 << (16 - length)
        if length + s <= 16:
            raw = (np.arange(span) >> (16 - length - s)) & ((1 << s) - 1)
            val = np.where(raw < (1 << (s - 1)), raw - (1 << s) + 1,
                           raw) if s else 0
            lut[lo:lo + span] = (val << 9) | (run << 5) | (length + s)
        else:
            lut[lo:lo + span] = (length << 13) | (sym << 5)
    return lut.tolist()


def _huffman_symbols(counts: bytes, symbols: bytes, is_dc: bool) -> list:
    """A 65536-entry peek table of (length << 13) | (symbol << 5) for
    every code, 0 where no code starts (the progressive decoder reads the
    appended bits itself)."""
    lut = np.zeros(65536, np.int64)
    for code, length, sym in _codes(counts, symbols, is_dc):
        lo = code << (16 - length)
        lut[lo:lo + (1 << (16 - length))] = (length << 13) | (sym << 5)
    return lut.tolist()


class _Tables:
    """DQT / DHT / DRI state, which may change between scans."""

    def __init__(self):
        self.quant = [None] * 4
        self.dc = [None] * 4   # (counts, symbols)
        self.ac = [None] * 4
        self.restart = 0
        self._luts = {}

    def read_dqt(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            n = 64 * (pq + 1)
            if pq > 1 or tq > 3 or pos + 1 + n > len(body):
                raise ValueError("JPEG: bad DQT segment")
            raw = body[pos + 1:pos + 1 + n]
            zz = np.frombuffer(raw, ">u2" if pq else np.uint8)
            q = np.zeros(64, np.int32)
            # quantval is u16, the islow multiplier table holds it as short
            q[ZIGZAG] = zz.astype(np.uint16).astype(np.int16)
            self.quant[tq] = q
            pos += 1 + n

    def read_dht(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            if pos + 17 > len(body):
                raise ValueError("JPEG: bad DHT segment")
            tc, th = body[pos] >> 4, body[pos] & 15
            counts = body[pos + 1:pos + 17]
            n = sum(counts)
            if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
                raise ValueError("JPEG: bad DHT segment")
            (self.ac if tc else self.dc)[th] = (counts,
                                                body[pos + 17:pos + 17 + n])
            pos += 17 + n

    def std_tables(self) -> None:
        """jstdhuff.c: default tables into DC/AC slots 0 and 1 still empty
        when the (sequential) Huffman decoder starts."""
        for i in range(2):
            self.dc[i] = self.dc[i] or _STD_DC[i]
            self.ac[i] = self.ac[i] or _STD_AC[i]

    def lut(self, cls: int, slot: int, symbols: bool = False) -> list:
        """The peek table of DC (cls 0) or AC (1) slot `slot`: with values
        (`_huffman_lut`), or with symbols only (`_huffman_symbols`)."""
        table = (self.ac if cls else self.dc)[slot]
        if table is None:
            raise ValueError(f"JPEG: Huffman table {slot} not defined")
        key = (cls, table, symbols)
        if key not in self._luts:
            build = _huffman_symbols if symbols else _huffman_lut
            self._luts[key] = build(*table, is_dc=not cls)
        return self._luts[key]


def _windows(data: bytes) -> list:
    """w[i] = the 48 bits of data[i:i + 6], big-endian; past the end the
    stream reads as zeros."""
    b = np.frombuffer(data + bytes(_PAD), np.uint8).astype(np.int64)
    n = len(data) + _PAD - 5
    w = np.zeros(n, np.int64)
    for j in range(6):
        w = (w << 8) | b[j:j + n]
    return w.tolist()


def _scan_data(data: bytes, pos: int, restart: int, n_intervals: int):
    """The entropy-coded data of the scan starting at `pos`: (windows,
    bit offset where each restart interval starts, bit offset where each
    ends, position of the marker after the scan)."""
    m = _SCAN_END.search(data, pos)
    if m is None:
        raise ValueError("JPEG: truncated scan")
    seg = data[pos:m.start()]
    parts = [seg]
    if restart:
        parts, last = [], 0
        for i, r in enumerate(_RST.finditer(seg)):
            if r.group(1)[0] != 0xD0 + (i & 7):
                raise ValueError("JPEG: restart marker out of sequence")
            parts.append(seg[last:r.start()])
            last = r.end()
        parts.append(seg[last:])
        if len(parts) < n_intervals:
            raise ValueError("JPEG: restart intervals missing")
    starts, ends, total = [], [], 0
    chunks = []
    for part in parts:
        part = _STUFFED.sub(b"\xff", part)
        starts.append(total)
        total += 8 * len(part)
        ends.append(total)
        chunks.append(part)
    return _windows(b"".join(chunks)), starts, ends, m.start()


def _scan_blocks(frame: _Frame, comps: list) -> tuple[list, list, int]:
    """The blocks of one scan in decode order: (index into `comps` of each
    block's component, each block's coefficient offset, blocks an MCU).
    An interleaved scan walks MCUs of h x v blocks of each component; a
    scan of one component walks its blocks holding samples one by one
    (not the MCU-padded count)."""
    if len(comps) == 1:
        c = comps[0]
        by, bx = np.mgrid[0:c.bh, 0:c.bw]
        bases = ((by * c.stride + bx) * 64).ravel().tolist()
        return [0] * len(bases), bases, 1
    if sum(c.h * c.v for c in comps) > 10:
        raise ValueError("JPEG: too many blocks in an MCU")
    my, mx = np.mgrid[0:frame.mcu_rows, 0:frame.mcu_cols]
    cols, which = [], []
    for i, c in enumerate(comps):
        dy, dx = np.mgrid[0:c.v, 0:c.h]
        mcu = (my * c.v * c.stride + mx * c.h).reshape(-1, 1)
        cols.append((mcu + (dy * c.stride + dx).reshape(1, -1)) * 64)
        which += [i] * (c.h * c.v)
    bases = np.concatenate(cols, 1)
    return which * bases.shape[0], bases.ravel().tolist(), bases.shape[1]


def _intervals(n_blocks: int, per_mcu: int, restart: int):
    """(first, end) block of each restart interval."""
    step = restart * per_mcu if restart else n_blocks
    return [(lo, min(lo + step, n_blocks)) for lo in range(0, n_blocks, step)]


def _extend(raw: int, s: int) -> int:
    return raw - (1 << s) + 1 if raw < 1 << (s - 1) else raw


def _decode_sequential(wl, starts, ends, which, bases, spans, coefs,
                       luts) -> None:
    """Baseline / extended sequential Huffman scan: every block's DC
    difference and AC run/size symbols into its coefficients (zigzag)."""
    for interval, (lo, hi) in enumerate(spans):
        p = starts[interval]
        pred = [0] * len(coefs)
        for ci, base in zip(which[lo:hi], bases[lo:hi]):
            coef = coefs[ci]
            dc, ac = luts[ci]
            e = dc[(wl[p >> 3] >> (32 - (p & 7))) & 0xFFFF]
            n = e & 31
            if n:
                p += n
                diff = e >> 9
            else:
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                p += e >> 13
                s = (e >> 5) & 15
                diff = _extend((wl[p >> 3] >> (48 - (p & 7) - s))
                               & ((1 << s) - 1), s)
                p += s
            val = pred[ci] + diff
            pred[ci] = val
            coef[base] = val
            k = 1
            while k < 64:
                e = ac[(wl[p >> 3] >> (32 - (p & 7))) & 0xFFFF]
                n = e & 31
                if n:
                    p += n
                    val = e >> 9
                    if val:
                        k += (e >> 5) & 15
                        if k > 63:
                            raise ValueError("JPEG: AC run past the block")
                        coef[base + k] = val
                        k += 1
                    elif (e >> 5) & 15 == 15:
                        k += 16
                    else:
                        break
                else:
                    if not e:
                        raise ValueError("JPEG: bad Huffman code")
                    p += e >> 13
                    sym = (e >> 5) & 255
                    s = sym & 15
                    k += sym >> 4
                    if k > 63:
                        raise ValueError("JPEG: AC run past the block")
                    coef[base + k] = _extend(
                        (wl[p >> 3] >> (48 - (p & 7) - s)) & ((1 << s) - 1), s)
                    p += s
                    k += 1
        if p > ends[interval]:
            raise ValueError("JPEG: entropy data ran short")


class _Bits:
    """A bit reader over a scan's windows for the progressive decoder."""

    __slots__ = ("wl", "p")

    def __init__(self, wl):
        self.wl, self.p = wl, 0

    def get(self, n: int) -> int:
        p = self.p
        self.p = p + n
        return (self.wl[p >> 3] >> (48 - (p & 7) - n)) & ((1 << n) - 1)

    def symbol(self, lut) -> int:
        """One Huffman symbol (its appended bits are left unread)."""
        p = self.p
        e = lut[(self.wl[p >> 3] >> (32 - (p & 7))) & 0xFFFF]
        if not e:
            raise ValueError("JPEG: bad Huffman code")
        self.p = p + (e >> 13)
        return (e >> 5) & 255


def _decode_progressive(bits, starts, ends, which, bases, spans, coefs, luts,
                        scan) -> None:
    """One progressive scan (jdphuff.c): DC first / refine over blocks of
    one or more components, AC first / refine over one component's
    blocks, with EOB runs and correction bits."""
    ss, se, ah, al = scan
    p1, m1 = 1 << al, -1 << al
    for interval, (lo, hi) in enumerate(spans):
        bits.p = starts[interval]
        pred = [0] * len(coefs)
        eobrun = 0
        for ci, base in zip(which[lo:hi], bases[lo:hi]):
            coef = coefs[ci]
            if ss == 0:
                if ah == 0:  # DC first
                    s = bits.symbol(luts[ci])
                    diff = _extend(bits.get(s), s) if s else 0
                    val = pred[ci] + diff
                    pred[ci] = val
                    coef[base] = val << al
                elif bits.get(1):  # DC refine
                    coef[base] |= p1
            elif ah == 0:  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                lut = luts[ci]
                k = ss
                while k <= se:
                    sym = bits.symbol(lut)
                    r, s = sym >> 4, sym & 15
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError("JPEG: AC run past the block")
                        coef[base + k] = _extend(bits.get(s), s) << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits.get(r) if r else 0) - 1
                        break
                    k += 1
            else:  # AC refine
                k = ss
                if not eobrun:
                    lut = luts[ci]
                    while k <= se:
                        sym = bits.symbol(lut)
                        r, s = sym >> 4, sym & 15
                        if s:
                            if s != 1:
                                raise ValueError("JPEG: bad refinement code")
                            s = p1 if bits.get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + (bits.get(r) if r else 0)
                            break
                        while k <= se:
                            c = coef[base + k]
                            if c:
                                if bits.get(1) and not c & p1:
                                    coef[base + k] = c + (p1 if c >= 0
                                                          else m1)
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            if k > 63:
                                raise ValueError("JPEG: AC run past the "
                                                 "block")
                            coef[base + k] = s
                        k += 1
                if eobrun:
                    while k <= se:
                        c = coef[base + k]
                        if c and bits.get(1) and not c & p1:
                            coef[base + k] = c + (p1 if c >= 0 else m1)
                        k += 1
                    eobrun -= 1
        if bits.p > ends[interval]:
            raise ValueError("JPEG: entropy data ran short")


# -- IDCT ---------------------------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
# jidctint.c's FIX() constants
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172
_IDCT_CHUNK = 16384  # blocks per pass: bounds the temporaries
# Zigzag positions of the coefficients in rows 1-7 (vertical frequency > 0).
_ROWS_1_7 = np.nonzero(ZIGZAG >= 8)[0]


def _wrap16(a: np.ndarray) -> np.ndarray:
    return ((a + 32768) & 0xFFFF) - 32768


def _idct_1d(x: list, shift: int) -> list:
    """One pass of jpeg_idct_islow over x[0..7] (int32 arrays of 16-bit
    values), as libjpeg-turbo's x86 SIMD computes it: jidctint.c's sums
    and products regrouped without rounding (the rotations as two-term
    dot products), except that in0 + in4, in0 - in4, in7 + in3 and
    in5 + in1 are 16-bit sums; each output rounded, shifted by `shift`
    and saturated to 16 bits."""
    x0, x1, x2, x3, x4, x5, x6, x7 = x
    tmp0 = _wrap16(x0 + x4) << _CONST_BITS
    tmp1 = _wrap16(x0 - x4) << _CONST_BITS
    tmp2 = x2 * _F0541 + x6 * (_F0541 - _F1847)
    tmp3 = x2 * (_F0541 + _F0765) + x6 * _F0541
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    z3, z4 = _wrap16(x7 + x3), _wrap16(x5 + x1)
    z3, z4 = (z3 * (_F1175 - _F1961) + z4 * _F1175,
              z3 * _F1175 + z4 * (_F1175 - _F0390))
    o0 = x7 * (_F0298 - _F0899) - x1 * _F0899 + z3
    o1 = x5 * (_F2053 - _F2562) - x3 * _F2562 + z4
    o2 = x3 * (_F3072 - _F2562) - x5 * _F2562 + z3
    o3 = x1 * (_F1501 - _F0899) - x7 * _F0899 + z4

    half = 1 << (shift - 1)
    return [np.clip((a + half) >> shift, -32768, 32767) for a in (
        tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
        tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)]


def _idct_plane(c: _Component) -> np.ndarray:
    """The component's samples, (bh*8, bw*8) u8 over its MCU-padded
    block array: the dequantised islow IDCT of every block, its output
    clamped to [-128, 127] and centred on 128."""
    rows = len(c.coef) // (64 * c.stride)
    # JCOEF and the islow multiplier are shorts; the SIMD dequantisation
    # keeps the low 16 bits of their product.
    zz = np.frombuffer(c.coef, np.int32).reshape(-1, 64).astype(np.int16)
    quant = np.zeros(64, np.int32) if c.quant is None else c.quant
    out = np.empty((zz.shape[0], 8, 8), np.uint8)
    for lo in range(0, zz.shape[0], _IDCT_CHUNK):
        blk = np.empty((min(_IDCT_CHUNK, zz.shape[0] - lo), 64), np.int32)
        blk[:, ZIGZAG] = zz[lo:lo + _IDCT_CHUNK]
        blk = _wrap16(blk * quant).reshape(-1, 8, 8)
        # Pass 1 down the columns (input rows are vertical frequencies),
        # pass 2 along the rows of its result.
        ws = np.stack(_idct_1d([blk[:, i] for i in range(8)],
                               _CONST_BITS - _PASS1_BITS), 1)
        # A block whose rows 1-7 hold no coefficient takes the SIMD pass
        # 1's shortcut: row 0 shifted by PASS1_BITS in 16 bits (wrapping
        # where the full pass saturates).
        flat = zz[lo:lo + blk.shape[0]].reshape(-1, 64)
        dc_rows = ~flat[:, _ROWS_1_7].any(1)
        ws[dc_rows] = _wrap16(blk[dc_rows, :1] << _PASS1_BITS)
        res = _idct_1d([ws[:, :, i] for i in range(8)],
                       _CONST_BITS + _PASS1_BITS + 3)
        out[lo:lo + blk.shape[0]] = np.clip(np.stack(res, 2), -128,
                                            127) + 128
    return out.reshape(rows, c.stride, 8, 8).transpose(0, 2, 1, 3).reshape(
        rows * 8, c.stride * 8)


# -- upsampling and colour ----------------------------------------------------

def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample along the last axis, edges replicated: output
    2i is (3 x[i] + x[i-1] + 1) >> 2, output 2i+1 is
    (3 x[i] + x[i+1] + 2) >> 2."""
    x = x.astype(np.int32)
    left = np.concatenate([x[..., :1], x[..., :-1]], -1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], -1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int32)
    out[..., 0::2] = (3 * x + left + 1) >> 2
    out[..., 1::2] = (3 * x + right + 2) >> 2
    return out


def _colsums_v2(x: np.ndarray):
    """The vertical triangle of h2v2 / h1v2: per input row, 3 x + the row
    above (for the upper output row) and 3 x + the row below (the lower
    one), rows replicated at the top and bottom."""
    x = x.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    return 3 * x + above, 3 * x + below


def _upsample(plane: np.ndarray, c: _Component, frame: _Frame) -> np.ndarray:
    """One component's samples (downsampled size) to the frame's MCU grid,
    as libjpeg-turbo's jinit_upsampler picks the method with fancy
    upsampling on."""
    fh, fv = frame.hmax // c.h, frame.vmax // c.v
    if frame.hmax % c.h or frame.vmax % c.v:
        raise ValueError("JPEG: fractional sampling ratio")
    dw = -(-frame.width * c.h // frame.hmax)
    dh = -(-frame.height * c.v // frame.vmax)
    x = plane[:dh, :dw]
    if (fh, fv) == (1, 1):
        return x
    if (fh, fv) == (2, 1) and dw > 2:
        return _fancy_h2(x).astype(np.uint8)
    if (fh, fv) == (1, 2):
        up, down = _colsums_v2(x)
        out = np.empty((2 * dh, dw), np.uint8)
        out[0::2] = (up + 1) >> 2
        out[1::2] = (down + 2) >> 2
        return out
    if (fh, fv) == (2, 2) and dw > 2:
        out = np.empty((2 * dh, 2 * dw), np.uint8)
        for parity, cs in enumerate(_colsums_v2(x)):
            left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
            out[parity::2, 0::2] = (3 * cs + left + 8) >> 4
            out[parity::2, 1::2] = (3 * cs + right + 7) >> 4
        return out
    return np.repeat(np.repeat(x, fv, 0), fh, 1)  # int_upsample


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + _ONE_HALF) >> _SCALEBITS
    cb_b = (_fix(1.77200) * x + _ONE_HALF) >> _SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + _ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_rgb(y, cb, cr) -> list:
    """jdcolor.c's ycc_rgb_convert, the sums clamped (sample_range_limit)."""
    y = y.astype(np.int64)
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    return [np.clip(v, 0, 255).astype(np.uint8)
            for v in (y + _CR_R[cr], g, y + _CB_B[cb])]


def _cmyk_rgb(cmyk: list) -> np.ndarray:
    """Pillow: rawmode "CMYK;I" inverts the four samples, then
    convert("RGB") takes Convert.c's cmyk2rgb: nk - nk * c / 255 with
    MULDIV255's rounding."""
    c, m, y, k = (255 - v.astype(np.int32) for v in cmyk)
    nk = 255 - k
    out = []
    for v in (c, m, y):
        t = v * nk + 128
        out.append(np.clip(nk - (((t >> 8) + t) >> 8), 0, 255))
    return np.stack(out, -1).astype(np.uint8)


def _color_space(frame: _Frame, jfif: bool, adobe: int | None) -> str:
    """libjpeg's default_decompress_parms: the file's colour space."""
    n = len(frame.comps)
    if n == 1:
        return "gray"
    if n == 3:
        if jfif:
            return "ycc"
        if adobe is not None:
            return "rgb" if adobe == 0 else "ycc"
        ids = [c.id for c in frame.comps]
        return "rgb" if ids == [82, 71, 66] else "ycc"  # 'R', 'G', 'B'
    if adobe is not None and adobe != 0:
        return "ycck"
    return "cmyk"


def _to_rgb(frame: _Frame, jfif: bool, adobe: int | None) -> np.ndarray:
    h, w = frame.height, frame.width
    planes = [_upsample(_idct_plane(c), c, frame)[:h, :w]
              for c in frame.comps]
    space = _color_space(frame, jfif, adobe)
    if space == "gray":
        return np.repeat(planes[0][..., None], 3, -1)
    if space == "rgb":
        return np.stack(planes, -1)
    if space == "ycc":
        return np.stack(_ycc_rgb(*planes), -1)
    if space == "ycck":  # ycck_cmyk_convert: 255 - the RGB sums, K as is
        y = planes[0].astype(np.int64)
        cb, cr = planes[1], planes[2]
        g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
        planes = [np.clip(255 - v, 0, 255).astype(np.uint8)
                  for v in (y + _CR_R[cr], g, y + _CB_B[cb])] + [planes[3]]
    return _cmyk_rgb(planes)


# -- the stream ---------------------------------------------------------------

def _read_sos(body: bytes, frame: _Frame):
    """(components, their DC and AC table slots, (Ss, Se, Ah, Al))."""
    if not body:
        raise ValueError("JPEG: bad SOS segment")
    n = body[0]
    if not 1 <= n <= 4 or len(body) != 4 + 2 * n:
        raise ValueError("JPEG: bad SOS segment")
    by_id = {c.id: c for c in frame.comps}
    comps, slots = [], []
    for i in range(n):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        c = by_id.get(cid)
        if c is None or c in comps:
            raise ValueError("JPEG: bad component in SOS")
        comps.append(c)
        slots.append((t >> 4, t & 15))
        if t >> 4 > 3 or t & 15 > 3:
            raise ValueError("JPEG: bad table slot in SOS")
    ss, se, a = body[1 + 2 * n:4 + 2 * n]
    return comps, slots, (ss, se, a >> 4, a & 15)


def _check_progression(scan, n_comps: int) -> None:
    """jdphuff.c's start_pass_phuff_decoder checks (fatal ones)."""
    ss, se, ah, al = scan
    bad = se != 0 if ss == 0 else (ss > se or se > 63 or n_comps != 1)
    if (ah and al != ah - 1) or al > 13 or bad:
        raise ValueError("JPEG: bad progression parameters")


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) u8 RGB, as Pillow's open + convert("RGB").

    Raises NotImplementedError for JPEG kinds the decoder does not read,
    ValueError for malformed data."""
    try:
        return _decode(data)
    except (IndexError, OverflowError, struct.error) as e:
        raise ValueError(f"JPEG: truncated or corrupt ({e})") from e


def _decode(data: bytes) -> np.ndarray:
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("JPEG: no SOI marker")
    pos = 2
    tables = _Tables()
    frame = None
    jfif, adobe = False, None
    scans = 0
    while True:
        if data[pos] != 0xFF:
            raise ValueError("JPEG: expected a marker")
        while data[pos] == 0xFF:  # fill bytes
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # no parameters
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError("JPEG: truncated marker segment")
        pos += length
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG: two SOF markers")
            frame = _Frame(marker, body)
        elif marker in _SOF_KINDS or marker == 0xCC:
            raise NotImplementedError(_SOF_KINDS.get(
                marker, "arithmetic-coded JPEG (DAC)"))
        elif marker == 0xDC:
            raise NotImplementedError("JPEG with a DNL marker")
        elif marker == 0xC4:
            tables.read_dht(body)
        elif marker == 0xDB:
            tables.read_dqt(body)
        elif marker == 0xDD:
            if len(body) != 2:
                raise ValueError("JPEG: bad DRI segment")
            (tables.restart,) = struct.unpack(">H", body)
        elif marker == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\x00")
        elif marker == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            if scans == 0 and not frame.progressive:
                tables.std_tables()
            pos = _scan(data, pos, body, frame, tables)
            scans += 1
        elif not (0xE1 <= marker <= 0xEF or marker == 0xFE):
            raise ValueError(f"JPEG: unexpected marker 0x{marker:02X}")
    if frame is None or not scans:
        raise ValueError("JPEG: no image")
    # libjpeg's block smoothing (jdcoefct.c smoothing_ok) predicts AC 1-9
    # that a progressive file's scans left incomplete.
    if frame.progressive and all(c.bits[0] >= 0 for c in frame.comps):
        if any(c.bits[k] for c in frame.comps for k in range(1, 10)):
            raise NotImplementedError(
                "progressive JPEG whose scans leave AC 1-9 incomplete "
                "(libjpeg's block smoothing)")
    return _to_rgb(frame, jfif, adobe)


def _scan(data: bytes, pos: int, body: bytes, frame: _Frame,
          tables: _Tables) -> int:
    """Decode the scan whose SOS body is `body` and whose data starts at
    `pos`; returns the position of the marker after it."""
    comps, slots, scan = _read_sos(body, frame)
    for c in comps:
        if c.quant is None:  # latch_quant_tables
            if tables.quant[c.tq] is None:
                raise ValueError(f"JPEG: quantisation table {c.tq} not "
                                 f"defined")
            c.quant = tables.quant[c.tq]
    which, bases, per_mcu = _scan_blocks(frame, comps)
    spans = _intervals(len(bases), per_mcu, tables.restart)
    wl, starts, ends, end = _scan_data(data, pos, tables.restart, len(spans))
    coefs = [c.coef for c in comps]
    if not frame.progressive:
        luts = [(tables.lut(0, d), tables.lut(1, a)) for d, a in slots]
        _decode_sequential(wl, starts, ends, which, bases, spans, coefs, luts)
        return end
    _check_progression(scan, len(comps))
    ss, se, ah, al = scan
    luts = [None] * len(comps)
    for i, (c, (d, a)) in enumerate(zip(comps, slots)):
        if ss == 0 and ah == 0:
            luts[i] = tables.lut(0, d, symbols=True)
        elif ss:
            luts[i] = tables.lut(1, a, symbols=True)
        for k in range(ss, se + 1):
            c.bits[k] = al
    _decode_progressive(_Bits(wl), starts, ends, which, bases, spans, coefs,
                        luts, scan)
    return end
