"""Writers of test media where no encoder is installed: baseline and
progressive JPEG encoders in numpy and a RIFF/AVI muxer for Motion-JPEG.

``encode_jpeg`` writes baseline JPEG at 4:2:0 (Y 2x2, Cb and Cr 1x1) with
libjpeg's quality-scaled tables (``jpeg_quality_scaling``) and the Annex K
Huffman tables; the DCT is a float one and the Huffman bit packing is
vectorised over the whole frame.  With ``dht=False`` the file carries no
DHT segment, as Motion-JPEG frames often do (decoders then use Annex K's).
``encode_progressive_jpeg`` writes the same coefficients as a progressive
JPEG in libjpeg's default scan script, with a Huffman table optimised for
each scan in a DHT before it.
``write_avi`` muxes frames into an AVI 1.0 file: ``hdrl`` with one
``vids`` stream (fourcc MJPG for JPEG frames, or another such as XVID for
MPEG-4 Part 2 samples), ``movi`` with one ``00dc`` chunk per frame, and an
``idx1`` index.  ``pack_divx`` packs decode-order MPEG-4 Part 2 samples
with B-VOPs as DivX 5 stores them in AVI (each B-VOP's chunk a display
slot earlier, N-VOP placeholders filling the slots left over).
"""

from __future__ import annotations

import struct

import numpy as np

# libjpeg's jcparam.c base tables (natural order) and Annex K Huffman tables
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])

_k = np.arange(8)
# orthonormal DCT-II rows: JPEG's 1/4 C(u) C(v) sum sum in two products
_DCT = np.sqrt(2 / 8) * np.cos((2 * _k[None, :] + 1) * _k[:, None] * np.pi / 16)
_DCT[0] /= np.sqrt(2)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table, baseline-clamped
    to 1..255 (natural order)."""
    q = min(max(quality, 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huff_codes(spec):
    """(code, length) per symbol of a canonical table (bits, symbols)."""
    bits, vals = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(rows/8, cols/8, 8, 8) blocks of a plane whose sides are multiples
    of 8."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _categories(v: np.ndarray):
    """JPEG magnitude category and its value bits of each integer."""
    a = np.abs(v)
    s = np.zeros(v.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v >= 0, v, v + (1 << s) - 1)
    return s, bits


def _coefficients(rgb: np.ndarray, quality: int):
    """The quantised blocks of a 4:2:0 JPEG of an HxWx3 uint8 RGB image:
    (H, W, luma table, chroma table, Y, Cb, Cr), each plane's blocks
    (rows, cols, 64) in zig-zag order over the image padded to whole
    16x16 MCUs by edge replication."""
    rgb = np.asarray(rgb, np.uint8)
    H, W = rgb.shape[:2]
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    img = np.pad(rgb, ((0, Hp - H), (0, Wp - W), (0, 0)),
                 mode="edge").astype(np.float64)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

    def down(c):
        return c.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3))

    qy = quant_table(_STD_LUMA_Q, quality)
    qc = quant_table(_STD_CHROMA_Q, quality)

    def coefs(plane, q):
        blk = _blocks(plane - 128.0)
        d = _DCT @ blk @ _DCT.T
        zz = np.rint(d.reshape(d.shape[:2] + (64,)) / q)[..., ZIGZAG]
        return zz.astype(np.int64)

    return H, W, qy, qc, coefs(y, qy), coefs(down(cb), qc), \
        coefs(down(cr), qc)


def _mcu_blocks(cy, ccb, ccr):
    """The blocks of every MCU in scan order (Y00 Y01 Y10 Y11 Cb Cr) and
    the component of each."""
    my, mx = ccb.shape[:2]
    ys = cy.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my * mx, 4, 64)
    blocks = np.concatenate([ys, ccb.reshape(-1, 1, 64),
                             ccr.reshape(-1, 1, 64)], axis=1).reshape(-1, 64)
    return blocks, np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)


def _pack(keys, codes, lens, interval_keys: int = 0) -> bytes:
    """Entropy-coded data: the codes in the order of their keys, MSB first,
    padded with one bits, 0xFF stuffed; with ``interval_keys``, each run
    of that many keys padded on its own and followed by the next restart
    marker (RST0 ... RST7 in turn)."""
    order = np.argsort(np.concatenate(keys), kind="stable")
    if interval_keys:
        key = np.concatenate(keys)[order]
        group = key // interval_keys
        cuts = np.flatnonzero(np.diff(group)) + 1
        parts = []
        for k, (a, b) in enumerate(zip(np.r_[0, cuts], np.r_[cuts,
                                                               len(key)])):
            if k:
                parts.append(bytes([0xFF, 0xD0 + (k - 1) % 8]))
            parts.append(_pack([key[a:b]], [np.concatenate(codes)[order][
                a:b]], [np.concatenate(lens)[order][a:b]]))
        return b"".join(parts)
    code = np.concatenate(codes)[order]
    length = np.concatenate(lens)[order]
    length, code = length[length > 0], code[length > 0]
    ends = np.cumsum(length)
    total = int(ends[-1]) if len(ends) else 0
    item = np.repeat(np.arange(len(code)), length)
    shift = ends[item] - 1 - np.arange(total)  # bit position within item
    bits = ((code[item] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()   # byte stuffing


def _header(H: int, W: int, qy, qc, sof: int) -> list:
    return [b"\xff\xd8", _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"),
            _segment(0xDB, bytes([0]) + bytes(qy[ZIGZAG].tolist())
                     + bytes([1]) + bytes(qc[ZIGZAG].tolist())),
            _segment(sof, struct.pack(">BHHB", 8, H, W, 3)
                     + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))]


def encode_jpeg(rgb: np.ndarray, quality: int = 95, dht: bool = True,
                restart_interval: int = 0) -> bytes:
    """Baseline 4:2:0 JPEG of an HxWx3 uint8 RGB image; with
    ``restart_interval``, a restart marker after every that many MCUs
    (DRI), each interval's DC predictions from zero."""
    H, W, qy, qc, cy, ccb, ccr = _coefficients(rgb, quality)
    blocks, comp = _mcu_blocks(cy, ccb, ccr)
    chroma = comp > 0
    nb = len(blocks)

    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
        if restart_interval:     # the first block of a component per interval
            mcu = sel // 6
            first = np.r_[True, mcu[1:] // restart_interval
                          != mcu[:-1] // restart_interval]
            diff[sel[first]] = dc[sel[first]]
    tabs = {name: _huff_codes(spec) for name, spec in (
        ("dcl", DC_LUMA), ("dcc", DC_CHROMA), ("acl", AC_LUMA),
        ("acc", AC_CHROMA))}

    def huff(sym, is_chroma, kind):
        cl, ll = tabs[kind + "l"]
        cc, lc = tabs[kind + "c"]
        return (np.where(is_chroma, cc[sym], cl[sym]),
                np.where(is_chroma, lc[sym], ll[sym]))

    keys, codes, lens = [], [], []
    s, vb = _categories(diff)
    hc, hl = huff(s, chroma, "dc")
    keys.append(np.arange(nb) * 1024)
    codes.append((hc << s) | vb)
    lens.append(hl + s)

    ac = blocks[:, 1:]
    bi, kk = np.nonzero(ac)                    # row-major: by block, then k
    kk = kk + 1
    v = ac[bi, kk - 1]
    first = np.r_[True, bi[1:] != bi[:-1]]
    prev = np.where(first, 0, np.r_[0, kk[:-1]])
    run = kk - prev - 1
    zrl, r = run // 16, run % 16
    s, vb = _categories(v)
    hc, hl = huff((r << 4) | s, chroma[bi], "ac")
    keys.append(bi * 1024 + kk * 8 + 4)
    codes.append((hc << s) | vb)
    lens.append(hl + s)
    zi = np.repeat(np.arange(len(bi)), zrl)    # runs of 16 zeros
    zj = np.arange(len(zi)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    hc, hl = huff(np.full(len(zi), 0xF0), chroma[bi[zi]], "ac")
    keys.append(bi[zi] * 1024 + kk[zi] * 8 + zj)
    codes.append(hc)
    lens.append(hl)
    last = np.zeros(nb, np.int64)              # end of block unless k=63
    np.maximum.at(last, bi, kk)
    eob = np.flatnonzero(last < 63)
    hc, hl = huff(np.zeros(len(eob), np.int64), chroma[eob], "ac")
    keys.append(eob * 1024 + 1000)
    codes.append(hc)
    lens.append(hl)

    out = _header(H, W, qy, qc, 0xC0)
    if dht:
        payload = b""
        for cls_id, spec in ((0x00, DC_LUMA), (0x10, AC_LUMA),
                             (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
            payload += bytes([cls_id] + spec[0] + spec[1])
        out.append(_segment(0xC4, payload))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                     0, 63, 0])))
    out += [_pack(keys, codes, lens, 6 * 1024 * restart_interval),
            b"\xff\xd9"]
    return b"".join(out)


# ------------------------------------------------------------ progressive

# libjpeg's jpeg_simple_progression for YCbCr: (components, Ss, Se, Ah, Al)
SIMPLE_PROGRESSION = (
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0))


def optimal_table(freq: np.ndarray):
    """A Huffman table (bits, symbols) for symbol counts ``freq`` (256),
    built as libjpeg's jpeg_gen_optimal_table does: Huffman's procedure
    with a reserved pseudo-symbol, then code lengths cut to 16 bits."""
    freq = [int(f) for f in freq] + [1]
    codesize, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i]]
        if len(live) < 2:
            break
        # the smallest counts; of equal ones the larger symbol
        c1 = min(live, key=lambda i: (freq[i], -i))
        c2 = min((i for i in live if i != c1), key=lambda i: (freq[i], -i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for c in range(257):
        if codesize[c]:
            bits[codesize[c]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [c for n in range(1, 33) for c in range(256) if codesize[c] == n]
    return bits[1:17], vals


def _shifted(v: np.ndarray, al: int) -> np.ndarray:
    """A coefficient's point transform in an AC scan: its magnitude
    shifted right by Al, the sign kept."""
    return np.where(v < 0, -((-v) >> al), v >> al)


def _eobrun_items(n: np.ndarray):
    """(symbol, extra bits, extra length) of end-of-band runs of n blocks
    (1..32767)."""
    r = np.floor(np.log2(np.maximum(n, 1))).astype(np.int64)
    return r << 4, n - (1 << r), r


def _runs(pending: np.ndarray, keys: np.ndarray):
    """Runs longer than 32767 blocks split into whole ones and the rest,
    each with its key."""
    if not (pending > 32767).any():
        return pending, keys
    n = [[32767] * (p // 32767) + ([p % 32767] if p % 32767 else [])
         for p in pending.tolist()]
    return (np.array([x for run in n for x in run], np.int64),
            np.repeat(keys, [len(run) for run in n]))


def _ac_first(blocks, ss, se, al):
    """Items (key, symbol, extra bits, extra length) of an AC first scan
    over ``blocks`` (n, 64) in scan order, with end-of-band runs as
    libjpeg's encoder counts them (encode_mcu_AC_first)."""
    band = _shifted(blocks[:, ss:se + 1], al)
    n, L = band.shape
    nz = band != 0
    has = nz.any(axis=1)
    lastk = np.where(has, L - 1 - np.argmax(nz[:, ::-1], axis=1), -1)
    trail = (lastk < L - 1).astype(np.int64)
    C = np.concatenate([[0], np.cumsum(trail)])
    F = np.flatnonzero(has)
    starts = np.concatenate([[0], F])
    stops = np.concatenate([F, [n]])
    pending = C[stops] - C[starts]
    pkeys = stops * 1024                       # before the block's codes
    keep = pending > 0
    runs, rkeys = _runs(pending[keep], pkeys[keep])
    sym, ext, elen = _eobrun_items(runs)
    items = [(rkeys, sym, ext, elen)]
    bi, kk = np.nonzero(nz)
    v = band[bi, kk]
    first = np.r_[True, bi[1:] != bi[:-1]] if len(bi) else np.zeros(0, bool)
    prev = np.where(first, -1, np.r_[-1, kk[:-1]])
    run = kk - prev - 1
    zrl, r = run // 16, run % 16
    s, vb = _categories(v)
    items.append((bi * 1024 + (kk + 1) * 8 + 4, (r << 4) | s, vb, s))
    zi = np.repeat(np.arange(len(bi)), zrl)
    zj = np.arange(len(zi)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    items.append((bi[zi] * 1024 + (kk[zi] + 1) * 8 + zj,
                  np.full(len(zi), 0xF0), np.zeros(len(zi), np.int64),
                  np.zeros(len(zi), np.int64)))
    return items


def _ac_refine(blocks, ss, se, al):
    """Items of an AC refinement scan over ``blocks``: each newly nonzero
    coefficient's run/size symbol and sign, the ZRLs, the correction bits
    of the coefficients already nonzero after the symbol that follows
    them (encode_mcu_AC_refine), and an end of band (a run of one block)
    where a block's band ends before its last coefficient."""
    a = np.abs(blocks[:, ss:se + 1]) >> al
    n, L = a.shape
    new, old, zero = a == 1, a > 1, a == 0
    pos = np.arange(L)
    eob = np.where(new.any(axis=1),
                   L - 1 - np.argmax(new[:, ::-1], axis=1), -1)
    zc = np.cumsum(zero, axis=1) - zero        # zeros before each position
    lastnew = np.maximum.accumulate(np.where(new, pos, -1), axis=1)
    lastnew = np.concatenate([np.full((n, 1), -1), lastnew[:, :-1]], axis=1)
    base = np.where(lastnew >= 0,
                    np.take_along_axis(zc, np.maximum(lastnew, 0), axis=1), 0)
    S = zc - base                              # zeros since the last new one
    bi, kk = np.nonzero((new | old) & (pos[None, :] <= eob[:, None]))
    Sj = S[bi, kk]
    same = np.r_[False, bi[1:] == bi[:-1]] if len(bi) else np.zeros(0, bool)
    prev_old = same & np.r_[False, old[bi[:-1], kk[:-1]]] if len(bi) else same
    Sprev = np.where(prev_old, np.r_[0, Sj[:-1]], 0)
    cnt = Sj // 16 - Sprev // 16
    is_new = new[bi, kk]
    event = (cnt > 0) | is_new
    eb, ek, ecnt, enew = bi[event], kk[event], cnt[event], is_new[event]

    def key(b, k, sub, aux):
        return ((b * 65 + k) * 8 + sub) * 64 + aux

    items = []
    # ZRLs: the first at sub 0, the rest at sub 2
    zi = np.repeat(np.arange(len(eb)), ecnt)
    zj = np.arange(len(zi)) - np.repeat(np.cumsum(ecnt) - ecnt, ecnt)
    items.append((key(eb[zi], ek[zi], np.where(zj == 0, 0, 2), zj),
                  np.full(len(zi), 0xF0), np.zeros(len(zi), np.int64),
                  np.zeros(len(zi), np.int64)))
    # newly nonzero: symbol (r << 4) | 1 and its sign
    nb_, nk = eb[enew], ek[enew]
    r = S[nb_, nk] % 16
    sign = (blocks[nb_, ss + nk] > 0).astype(np.int64)
    items.append((key(nb_, nk, 3, 0), (r << 4) | 1, sign,
                  np.ones(len(nb_), np.int64)))
    # correction bits: after the next event in the block, or the EOB
    ob, ok = np.nonzero(old)
    bit = a[ob, ok] & 1
    g_event = eb * 64 + ek
    idx = np.searchsorted(g_event, ob * 64 + ok, side="right")
    before_eob = ok < eob[ob]
    idx = np.minimum(idx, max(len(eb) - 1, 0))
    at_cnt = np.where(before_eob, ecnt[idx] if len(eb) else 0, 0)
    k_at = np.where(before_eob, ek[idx] if len(eb) else 0, 64)
    sub = np.where(before_eob, np.where(at_cnt > 0, 1, 5), 1)
    items.append((key(ob, k_at, sub, ok), np.full(len(ob), -1), bit,
                  np.ones(len(ob), np.int64)))
    # end of band: a run of one block
    tb = np.flatnonzero(eob < L - 1)
    items.append((key(tb, 64, 0, 0), np.zeros(len(tb), np.int64),
                  np.zeros(len(tb), np.int64), np.zeros(len(tb), np.int64)))
    return items


def _scan_data(items, table):
    """The entropy-coded bytes of a scan's items, each symbol coded by
    ``table`` ((code, length) arrays by symbol); symbol -1 is a raw bit."""
    code_of, len_of = table
    keys, codes, lens = [], [], []
    for k, sym, ext, elen in items:
        raw = sym < 0
        s = np.where(raw, 0, sym)
        hc = np.where(raw, 0, code_of[s])
        hl = np.where(raw, 0, len_of[s])
        keys.append(np.asarray(k, np.int64))
        codes.append((hc << elen) | ext)
        lens.append(hl + elen)
    return _pack(keys, codes, lens)


def _dht(cls_id: int, table) -> bytes:
    return bytes([cls_id] + list(table[0]) + list(table[1]))


def encode_progressive_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """Progressive 4:2:0 JPEG of an HxWx3 uint8 RGB image in libjpeg's
    default scan script (``SIMPLE_PROGRESSION``: 10 scans), with Huffman
    tables optimised for each scan as libjpeg makes them; its
    coefficients are ``encode_jpeg``'s, so both decode to the same
    pixels."""
    H, W, qy, qc, cy, ccb, ccr = _coefficients(rgb, quality)
    planes = (cy, ccb, ccr)
    real = [(-(-H // 8), -(-W // 8))] + [(-(-H // 16), -(-W // 16))] * 2
    mcu, comp = _mcu_blocks(cy, ccb, ccr)
    out = _header(H, W, qy, qc, 0xC2)
    for comps, ss, se, ah, al in SIMPLE_PROGRESSION:
        dht = b""
        if ss == 0:
            dc = mcu[:, 0] >> al
            if ah == 0:
                diff = np.empty_like(dc)
                for c in range(3):
                    sel = np.flatnonzero(comp == c)
                    diff[sel] = np.diff(dc[sel], prepend=0)
                s, vb = _categories(diff)
                tabs = []
                for t, sel in ((0, comp == 0), (1, comp > 0)):
                    tab = optimal_table(np.bincount(s[sel], minlength=256))
                    dht += _dht(t, tab)
                    tabs.append(_huff_codes(tab))
                chroma = comp > 0
                hc = np.where(chroma, tabs[1][0][s], tabs[0][0][s])
                hl = np.where(chroma, tabs[1][1][s], tabs[0][1][s])
                data = _pack([np.arange(len(mcu))], [(hc << s) | vb],
                             [hl + s])
            else:
                data = _pack([np.arange(len(mcu))], [dc & 1],
                             [np.ones(len(mcu), np.int64)])
            head = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11])
        else:
            c = comps[0]
            rows, cols = real[c]
            blocks = planes[c][:rows, :cols].reshape(-1, 64)
            items = (_ac_refine if ah else _ac_first)(blocks, ss, se, al)
            syms = np.concatenate([it[1] for it in items])
            tab = optimal_table(np.bincount(syms[syms >= 0], minlength=256))
            t = 0 if c == 0 else 1
            dht = _dht(0x10 | t, tab)
            data = _scan_data(items, _huff_codes(tab))
            head = bytes([1, c + 1, t])
        if dht:
            out.append(_segment(0xC4, dht))
        out.append(_segment(0xDA, head + bytes([ss, se, (ah << 4) | al])))
        out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_avi(path: str, frames: list, width: int, height: int,
              fourcc: bytes = b"MJPG", extradata: bytes = b"",
              bit_count: int = 24) -> None:
    """An AVI 1.0 file of ``frames`` (the bytes of each coded frame: JPEG
    for the default MJPG, MPEG-4 Part 2 samples with the VOL in the first
    for XVID) at 10 frames/s, every frame a key frame in the index;
    ``extradata`` (an FFV1 configuration record, HuffYUV's tables) follows
    the bitmap header, whose biBitCount is ``bit_count``."""
    fps, n = 10, len(frames)
    biggest = max((len(j) for j in frames), default=0)

    def chunk(fcc: bytes, data: bytes) -> bytes:
        return fcc + struct.pack("<I", len(data)) + data + b"\0" * (
            len(data) & 1)

    def lst(kind: bytes, data: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(data) + 4) + kind + data

    avih = struct.pack("<14I", 1000000 // fps, biggest * fps, 0, 0x10, n, 0,
                       1, biggest, width, height, 0, 0, 0, 0)
    strh = (b"vids" + fourcc
            + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, fps, 0, n, biggest,
                          -1, 0)
            + struct.pack("<4h", 0, 0, width, height))
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height,
                       1, bit_count, fourcc, width * height * 3, 0, 0, 0,
                       0) + extradata
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    chunks, index, off = [], [], 4             # offsets from "movi"
    for j in frames:
        c = chunk(b"00dc", j)
        index.append(b"00dc" + struct.pack("<III", 0x10, off, len(j)))
        chunks.append(c)
        off += len(c)
    body = hdrl + lst(b"movi", b"".join(chunks)) + chunk(b"idx1",
                                                        b"".join(index))
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body)


def vop_time_bits(sample: bytes) -> int:
    """vop_time_increment's width from the VOL in ``sample``."""
    data = sample[sample.index(b"\0\0\1\x20") + 4:]
    bits = "".join(f"{b:08b}" for b in data[:16])
    q = 9                                   # random_accessible, type
    if bits[q] == "1":                      # is_object_layer_identifier
        q += 7
    q += 1
    if bits[q:q + 4] == "1111":             # extended pixel aspect ratio
        q += 16
    q += 4
    if bits[q] == "1":                      # vol_control_parameters
        q += 3
        if bits[q + 1] == "1":              # vbv_parameters
            q += 79
        q += 1
    q += 1 + 2 + 1                          # shape, marker
    res = int(bits[q:q + 16], 2)
    return max(1, (res - 1).bit_length())


def with_user_data(sample: bytes, user: bytes) -> bytes:
    """``sample`` with its user data replaced by ``user`` (the text), or
    ``user`` put in front of its first VOP when it has none."""
    ud = b"\0\0\1\xb2"
    if ud in sample:
        i = sample.index(ud)
        j = sample.index(b"\0\0\1", i + 4)
        return sample[:i] + ud + user + sample[j:]
    i = sample.index(b"\0\0\1\xb6")
    return sample[:i] + ud + user + sample[i:]


def n_vop(vop: bytes, time_bits: int) -> bytes:
    """An N-VOP: the header of the VOP in ``vop`` as a P-VOP with
    vop_coded 0 (its modulo_time_base and vop_time_increment kept),
    stuffed to a byte."""
    start = vop.index(b"\0\0\1\xb6")
    bits = "".join(f"{b:08b}" for b in vop[start + 4:start + 16])
    q = 2
    while bits[q] == "1":                   # modulo_time_base
        q += 1
    out = "01" + bits[2:q + 1 + 1 + time_bits + 1] + "0"
    out += "0" + "1" * (-(len(out) + 1) % 8)
    return b"\0\0\1\xb6" + int(out, 2).to_bytes(len(out) // 8, "big")


def pack_divx(samples: list, user_data: bytes = b"DivX503b1393p",
              nvop: bool = True) -> list:
    """Decode-order MPEG-4 Part 2 samples (one VOP each, the VOL in the
    first) packed as DivX 5 stores B-VOPs in AVI: an I- or P-VOP that B-VOPs
    follow shares its chunk with the first of them, each further B-VOP
    takes a chunk of its own, and an N-VOP fills the chunk left over (none
    with ``nvop`` False), so each chunk stands for one display slot.
    ``user_data`` (None: left as it is) becomes the first sample's user
    data; DivX's ends in ``p``, which tells a decoder the stream is
    packed."""
    time_bits = vop_time_bits(samples[0])
    kinds = [s[s.index(b"\0\0\1\xb6") + 4] >> 6 for s in samples]
    out, i = [], 0
    while i < len(samples):
        j = i + 1
        while j < len(samples) and kinds[j] == 2:
            j += 1
        bs = samples[i + 1:j]
        if kinds[i] == 2 or not bs:
            out.append(samples[i])
        else:
            out.append(samples[i] + bs[0])
            out += bs[1:]
            if nvop:
                out.append(n_vop(bs[-1], time_bits))
        i = j
    if user_data is not None:
        out[0] = with_user_data(out[0], user_data)
    return out
