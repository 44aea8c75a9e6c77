"""Writers of test photos in numpy and the standard library, for machines
with no image encoder: binary PPM (P6), 24-bit BMP, TIFF (none, Deflate
or PackBits compression, with or without the horizontal predictor, in
strips or tiles, chunky or planar, 8 or 16-bit, either byte order, classic
or BigTIFF, with an Orientation tag; bilevel CCITT RLE, Group 3, Group 4
and RLEW pages through testing/ccitt.py), 16-bit RGB PNG and 8-bit PNG with
every row filtered Paeth, lossless WebP (still and animated), GIF from an
index image and its palette, Sun raster (1, 8, 24 or 32 bits, a palette,
run-length coded or not), PFM, Radiance HDR (new-style scanlines), and an
EXIF APP1 segment put into a JPEG.
Each ``encode_*`` returns the file's bytes; ``damage`` cuts or flips a
file's bytes from a seed (the damaged photo tests' cases and the committed
damaged fixtures chip_smoke.py holds come from it)."""

from __future__ import annotations

import heapq
import struct
import zlib

import numpy as np

from . import ccitt
from ..io.png import SIGNATURE as PNG_SIGNATURE
from ..io.png import _chunk as _png_chunk


def encode_ppm(rgb: np.ndarray) -> bytes:
    """Binary PPM (P6, maxval 255) of ``rgb`` [H,W,3] uint8."""
    h, w, _ = rgb.shape
    return f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(
        rgb, np.uint8).tobytes()


def encode_bmp(rgb: np.ndarray) -> bytes:
    """24-bit BI_RGB BMP (40-byte header, rows bottom-up, each padded to 4
    bytes) of ``rgb`` [H,W,3] uint8."""
    h, w, _ = rgb.shape
    pitch = (w * 3 + 3) & ~3
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                         2835, 2835, 0, 0)
    size = 14 + len(header) + rows.size
    return (b"BM" + struct.pack("<IHHI", size, 0, 0, 14 + len(header))
            + header + rows.tobytes())


def _png(w: int, h: int, depth: int, ctype: int, rows: bytes) -> bytes:
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows, 6))
            + _png_chunk(b"IEND", b""))


def encode_png16(rgb16: np.ndarray) -> bytes:
    """16-bit RGB PNG of ``rgb16`` [H,W,3] (any integer type, 0..65535),
    every row filtered Up."""
    h, w, _ = rgb16.shape
    rows = np.asarray(rgb16).astype(">u2").view(np.uint8).reshape(h, w * 6)
    up = rows.copy()
    up[1:] -= rows[:-1]
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1)
    return _png(w, h, 16, 2, raw.tobytes())


def paeth_filter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The Paeth filter of the unfiltered scanlines ``rows`` [H, stride]
    uint8 (``bpp`` bytes per pixel): each byte less the Paeth predictor of
    its left, upper and upper-left neighbours."""
    r = rows.astype(np.int16)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (r - pred).astype(np.uint8)


def encode_png_paeth(rgb: np.ndarray) -> bytes:
    """8-bit RGB PNG of ``rgb`` [H,W,3] uint8, every row filtered Paeth."""
    h, w, _ = rgb.shape
    f = paeth_filter(np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3), 3)
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), f], 1)
    return _png(w, h, 8, 2, raw.tobytes())


# encode_tiff's CCITT compressions -> testing/ccitt.py's modes
_FAX_MODES = {"ccitt_rle": "rle", "group3": "g3", "group4": "g4",
              "rlew": "rlew"}


def damage(data: bytes, seed: int, kind: str) -> bytes:
    """``data`` damaged from ``seed`` as files are: "cut" keeps a random
    prefix of at least 2 bytes (an interrupted copy or write), "flip"
    inverts one random bit, "flips" three, "byte" puts a random value in
    one random byte."""
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    if kind == "cut":
        return bytes(b[:int(rng.integers(2, len(b)))])
    count = {"flip": 1, "flips": 3, "byte": 1}[kind]
    for _ in range(count):
        i = int(rng.integers(0, len(b)))
        if kind == "byte":
            b[i] = int(rng.integers(0, 256))
        else:
            b[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


def _packbits(data: bytes) -> bytes:
    """PackBits of ``data`` as literal runs of up to 128 bytes."""
    out = bytearray()
    for i in range(0, len(data), 128):
        piece = data[i:i + 128]
        out.append(len(piece) - 1)
        out += piece
    return bytes(out)


def _differenced(block: np.ndarray) -> np.ndarray:
    """Horizontal differencing (Predictor 2) of samples [rows, cols, spp]
    along each row, wrapping in the samples' width."""
    d = block.copy()
    d[:, 1:] -= block[:, :-1]
    return d


def split_jpeg(stream: bytes) -> tuple[bytes, bytes]:
    """A JPEG ``stream`` as JPEG-in-TIFF stores it: (the tables-only
    datastream of its DQT and DHT segments, for the JPEGTables tag; the
    abbreviated stream of the rest, APPn segments dropped)."""
    tables, rest = [], []
    p = 2
    while p < len(stream):
        m = stream[p + 1]
        if m == 0xDA:
            rest.append(stream[p:])
            break
        seg = stream[p:p + 2 + int.from_bytes(stream[p + 2:p + 4], "big")]
        if m in (0xDB, 0xC4):
            tables.append(seg)
        elif not 0xE0 <= m <= 0xEF:
            rest.append(seg)
        p += len(seg)
    return (b"\xff\xd8" + b"".join(tables) + b"\xff\xd9",
            b"\xff\xd8" + b"".join(rest))


def ycbcr_units(block: np.ndarray, hs: int, vs: int) -> bytes:
    """Y, Cb, Cr samples [rows, cols, 3] uint8 as TIFF's YCbCr data units:
    hs*vs luma samples (rows of hs), then the unit's top left Cb and Cr;
    a unit cut by the block's edge repeats its last row and column."""
    rows, cols = block.shape[:2]
    down, across = -(-rows // vs), -(-cols // hs)
    pad = np.pad(block, ((0, down * vs - rows), (0, across * hs - cols),
                         (0, 0)), mode="edge")
    y = pad[..., 0].reshape(down, vs, across, hs).transpose(0, 2, 1, 3)
    return np.concatenate([y.reshape(down, across, vs * hs),
                           pad[::vs, ::hs, 1:]], axis=2).tobytes()


def encode_tiff(samples: np.ndarray, *, photometric: int = 2,
                compression: str = "none", predictor: int = 1,
                rows_per_strip: int | None = None,
                tile: tuple[int, int] | None = None, planar: bool = False,
                big_endian: bool = False, bigtiff: bool = False,
                orientation: int | None = None,
                extra_samples: tuple[int, ...] = (),
                colormap: np.ndarray | None = None,
                extra_tags: tuple = (), jpeg_encoder=None,
                subsampling: tuple[int, int] | None = None,
                t4_options: int = 0, fill_order: int = 1) -> bytes:
    """TIFF of ``samples`` [H,W,spp] (uint8 or uint16, or float16, 32 or
    64 with SampleFormat 3; [H,W] for one sample) with ``compression``
    "none", "deflate" (8), "packbits" or "jpeg" (7: each strip or tile
    coded by ``jpeg_encoder``, an RGB array to a JPEG, by default
    ``mjpeg.encode_jpeg`` at quality 95, 4:2:0 YCbCr for
    ``photometric`` 6, which gets YCbCrSubsampling 2, 2; the tables in
    JPEGTables, the strips abbreviated streams), the horizontal predictor
    where ``predictor`` is 2, in strips of ``rows_per_strip`` rows
    (default: one strip) or in tiles of ``tile`` = (width, height), chunky
    or ``planar``; ``colormap`` [3, 2^bits] for a palette image
    (``photometric`` 3); CMYK (``photometric`` 5) from four samples C, M,
    Y, K; YCbCr (``photometric`` 6) from samples Y, Cb, Cr, stored in
    data units of ``subsampling`` = (horizontal, vertical) luma samples and
    the Cb, Cr of each unit's top left one, with its YCbCrSubsampling tag;
    ``extra_tags`` (tag, field type, values; a rational as numerator and
    denominator) entries added to the directory, or put in place of the
    writer's own entry of the same tag.

    CCITT ``compression`` "ccitt_rle" (2), "group3" (3: 1D rows, or 2D
    ones with ``t4_options`` bit 0; EOLs ending on byte boundaries with bit
    2), "group4" (4) or "rlew" (32771) codes ``samples`` [H,W] of 0/1 as a
    1-bit image (1 black where ``photometric`` is 0, MinIsWhite, the
    default for them) by testing/ccitt.py, in the bit order of
    ``fill_order``."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    h, w, spp = s.shape
    bits = s.dtype.itemsize * 8
    fax = _FAX_MODES.get(compression)
    if fax is not None:
        bits, photometric = 1, 0 if photometric == 2 else photometric
        if compression == "group3" and t4_options & 1:
            fax = "g3_2d"
    e = ">" if big_endian else "<"
    dtype = s.dtype.newbyteorder(e) if bits > 8 else np.dtype(np.uint8)
    if tile is not None:
        cw, ch = tile
        across, down = -(-w // cw), -(-h // ch)
        padded = np.zeros((down * ch, across * cw, spp), s.dtype)
        padded[:h, :w] = s
    else:
        cw, ch = w, min(rows_per_strip or h, h)
        across, down = 1, -(-h // ch)
        padded = s
    code = {"none": 1, "deflate": 8, "packbits": 32773, "jpeg": 7,
            "ccitt_rle": 2, "group3": 3, "group4": 4,
            "rlew": 32771}[compression]
    if code == 7 and jpeg_encoder is None:
        from .mjpeg import encode_jpeg as jpeg_encoder
    chunks, tables = [], None
    for plane in range(spp if planar else 1):
        for ty in range(down):
            for tx in range(across):
                block = padded[ty * ch:(ty + 1) * ch, tx * cw:(tx + 1) * cw]
                if planar:
                    block = block[:, :, plane:plane + 1]
                if predictor == 2:
                    block = _differenced(block)
                raw = np.ascontiguousarray(block).astype(dtype).tobytes()
                if subsampling is not None:
                    raw = ycbcr_units(block, *subsampling)
                if fax is not None:
                    raw = ccitt.strip(block[..., 0], fax,
                                      eol_align=bool(t4_options & 4),
                                      lsb_first=fill_order == 2)
                elif code == 7:
                    tables, raw = split_jpeg(jpeg_encoder(
                        np.ascontiguousarray(block)))
                elif code == 8:
                    raw = zlib.compress(raw, 6)
                elif code == 32773:
                    raw = _packbits(raw)
                chunks.append(raw)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [code]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [2 if planar else 1])]
    if predictor == 2:
        entries.append((317, 3, [2]))
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if code == 3:
        entries.append((292, 4, [t4_options]))
    if subsampling is not None:
        entries.append((530, 3, list(subsampling)))
    if code == 7:
        entries.append((347, 7, list(tables)))
        if photometric == 6:
            entries.append((530, 3, [2, 2]))
    if s.dtype.kind == "f":
        entries.append((339, 3, [3] * spp))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if extra_samples:
        entries.append((338, 3, list(extra_samples)))
    if colormap is not None:
        entries.append((320, 3, np.asarray(colormap).reshape(-1).tolist()))
    if tile is not None:
        entries += [(322, 3, [cw]), (323, 3, [ch])]
        off_tag, count_tag = 324, 325
    else:
        entries.append((278, 4, [ch]))
        off_tag, count_tag = 273, 279
    offset_type = 16 if bigtiff else 4
    entries += [(off_tag, offset_type, [0] * len(chunks)),
                (count_tag, offset_type, [len(c) for c in chunks])]
    replaced = {tag for tag, _, _ in extra_tags}
    entries = [t for t in entries if t[0] not in replaced] + list(extra_tags)
    entries.sort(key=lambda t: t[0])
    codes = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 8: "h",
             9: "i", 10: "i", 16: "Q"}
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 5: 4, 7: 1, 8: 2, 9: 4, 10: 4, 16: 8}
    word, inline = ("Q", 8) if bigtiff else ("I", 4)
    head = ((b"MM" if big_endian else b"II")
            + (struct.pack(e + "HHHQ", 43, 8, 0, 16) if bigtiff
               else struct.pack(e + "HI", 42, 8)))
    ifd_at = len(head)
    entry_size = 20 if bigtiff else 12
    ifd_len = (8 if bigtiff else 2) + entry_size * len(entries) + inline
    data_at = ifd_at + ifd_len
    # out-of-line values, then the chunks
    blobs, where = [], {}
    for tag, ftype, values in entries:
        size = sizes[ftype] * len(values)
        if size > inline:
            where[tag] = data_at + sum(len(b) for b in blobs)
            blobs.append(b"\0" * size)
    chunk_at = data_at + sum(len(b) for b in blobs)
    chunk_offsets = []
    for c in chunks:
        chunk_offsets.append(chunk_at)
        chunk_at += len(c)
    blobs = []
    ifd = struct.pack(e + ("Q" if bigtiff else "H"), len(entries))
    for tag, ftype, values in entries:
        if tag == off_tag:
            values = chunk_offsets
        packed = struct.pack(f"{e}{len(values)}{codes[ftype]}", *values)
        count = len(values) // 2 if ftype in (5, 10) else len(values)
        head_fields = struct.pack(e + "HH" + word, tag, ftype, count)
        if len(packed) > inline:
            ifd += head_fields + struct.pack(e + word, where[tag])
            blobs.append(packed)
        else:
            ifd += head_fields + packed.ljust(inline, b"\0")
    ifd += struct.pack(e + word, 0)
    return head + ifd + b"".join(blobs) + b"".join(chunks)


def exif_block(orientation: int, big_endian: bool = False) -> bytes:
    """A TIFF-structured EXIF block whose first directory holds only the
    Orientation tag (SHORT) with ``orientation``."""
    e = ">" if big_endian else "<"
    return ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "HHHIHHI", 1, 0x0112, 3, 1, orientation, 0, 0))


def insert_exif(jpeg: bytes, orientation: int,
                big_endian: bool = False) -> bytes:
    """``jpeg`` with an ``Exif`` APP1 segment (``exif_block``) right after
    its SOI marker."""
    body = b"Exif\0\0" + exif_block(orientation, big_endian)
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + jpeg[2:])


def _pack_bits(values, lengths) -> bytes:
    """The ``values`` (each below 2**its ``lengths`` bits, at most 64) one
    after the other, least significant bit first, as bytes (the last one
    padded with zeros)."""
    v = np.ascontiguousarray(values, np.uint64)
    n = np.asarray(lengths, np.int64)
    if not len(v):
        return b""
    start = np.cumsum(n) - n
    total = int(start[-1] + n[-1])
    words = np.zeros(total // 64 + 2, np.uint64)
    word, off = start >> 6, (start & 63).astype(np.uint64)
    low = v << off
    high = np.where(off == 0, np.uint64(0), v >> ((64 - off) & 63))
    runs = np.flatnonzero(np.diff(word, prepend=-1))  # values of one word
    words[word[runs]] |= np.bitwise_or.reduceat(low, runs)
    words[word[runs] + 1] |= np.bitwise_or.reduceat(high, runs)
    return words.astype("<u8").view(np.uint8)[:(total + 7) // 8].tobytes()


def _huffman_lengths(counts, limit: int) -> np.ndarray:
    """Code lengths, none over ``limit``, of a Huffman code for the symbol
    ``counts`` (0 for a symbol not used; 1 for the one symbol used)."""
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if len(used) == 1:
        lengths[used] = 1
        return lengths
    c = counts[used]
    while True:
        depth = np.zeros(len(c), np.int64)
        heap = [(int(n), i, [i]) for i, n in enumerate(c)]
        heapq.heapify(heap)
        while len(heap) > 1:
            n1, i1, m1 = heapq.heappop(heap)
            n2, _, m2 = heapq.heappop(heap)
            depth[m1 + m2] += 1
            heapq.heappush(heap, (n1 + n2, i1, m1 + m2))
        if depth.max() <= limit:
            lengths[used] = depth
            return lengths
        c = (c + 1) // 2                  # flatten the counts and retry


def _reversed_codes(lengths: np.ndarray) -> np.ndarray:
    """The canonical codes of ``lengths`` (by length, then symbol), each
    bit-reversed to be written least significant bit first; 0 bits long
    where only one symbol is used."""
    codes = np.zeros(len(lengths), np.uint64)
    code = 0
    for length in range(1, int(lengths.max()) + 1):
        for s in np.flatnonzero(lengths == length):
            codes[s] = int(format(code, f"0{length}b")[::-1], 2)
            code += 1
        code <<= 1
    return codes


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)
_SELECT = 11                    # the VP8L predictor the writer uses
_TILE_BITS = 9                  # one mode per 512x512 tile


def _simple_code(symbol: int) -> list:
    """A VP8L simple prefix code of one 8-bit symbol (read in 0 bits)."""
    return [(1, 1), (0, 1), (1, 1), (symbol, 8)]


def _normal_code(lengths: np.ndarray) -> list:
    """A VP8L normal prefix code of ``lengths``: all 19 code-length code
    lengths, then every symbol's length through that code (no repeats)."""
    cl = _huffman_lengths(np.bincount(lengths, minlength=19), 7)
    out = [(0, 1), (19 - 4, 4)]
    out += [(int(cl[k]), 3) for k in _CODE_LENGTH_ORDER]
    out.append((0, 1))                   # max_symbol: the whole alphabet
    if np.count_nonzero(cl) > 1:
        rev = _reversed_codes(cl)
        out += [(int(rev[n]), int(cl[n])) for n in lengths]
    return out


def _select_residuals(s: np.ndarray) -> np.ndarray:
    """``s`` [H,W,3] int16 less its VP8L predictions: black for the first
    pixel, the left one along the first row, the one above down the first
    column, and mode 11 (select between left and above by their distance
    to left + above - above-left) elsewhere; in 0..255."""
    left = np.zeros_like(s)
    left[:, 1:] = s[:, :-1]
    top = np.zeros_like(s)
    top[1:] = s[:-1]
    tl = np.zeros_like(s)
    tl[1:, 1:] = s[:-1, :-1]
    d = (np.abs(left - tl) - np.abs(top - tl)).sum(-1, keepdims=True)
    pred = np.where(d <= 0, top, left)
    pred[0, 1:] = s[0, :-1]
    pred[1:, 0] = s[:-1, 0]
    pred[0, 0] = 0
    return (s - pred) & 255


def vp8l_stream(rgb: np.ndarray) -> bytes:
    """The VP8L bitstream (a ``VP8L`` chunk's payload) of ``rgb`` [H,W,3]
    uint8, opaque: the subtract-green transform, then the predictor
    transform (mode 11 in every tile), then normal prefix codes for green,
    red and blue, no LZ77, colour cache or meta prefix codes."""
    h, w, _ = rgb.shape
    s = np.asarray(rgb, np.int16)
    s = np.stack([s[..., 0] - s[..., 1], s[..., 1], s[..., 2] - s[..., 1]],
                 -1) & 255                       # subtract green
    res = _select_residuals(s)
    head = [(0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (0, 3),
            (1, 1), (2, 2),                       # subtract green
            (1, 1), (0, 2), (_TILE_BITS - 2, 3),  # predictor, its modes:
            (0, 1), *_simple_code(_SELECT), *_simple_code(0),
            *_simple_code(0), *_simple_code(255), *_simple_code(0),
            (0, 1),                               # no more transforms
            (0, 1), (0, 1)]                       # no cache, no meta codes
    values, lengths = [], []
    for ch, size in ((1, 280), (0, 256), (2, 256)):  # green, red, blue
        ln = _huffman_lengths(np.bincount(res[..., ch].ravel(),
                                          minlength=size), 15)
        head += _normal_code(ln)
        if np.count_nonzero(ln) > 1:
            sym = res[..., ch].ravel()
            values.append(_reversed_codes(ln)[sym])
            lengths.append(ln[sym])
    head += _simple_code(0) + _simple_code(0)    # alpha residual 0; distance
    v = np.zeros(h * w, np.uint64)
    n = np.zeros(h * w, np.int64)
    for val, ln in zip(values, lengths):        # green, red, blue per pixel
        v |= val << n.astype(np.uint64)
        n += ln
    return _pack_bits(np.concatenate([np.array([x for x, _ in head],
                                               np.uint64), v]),
                      np.concatenate([np.array([b for _, b in head],
                                               np.int64), n]))


def _riff_webp(chunks) -> bytes:
    body = b"WEBP" + b"".join(
        kind + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)
        for kind, data in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def encode_webp_lossless(rgb: np.ndarray) -> bytes:
    """Lossless WebP (a ``VP8L`` chunk alone) of ``rgb`` [H,W,3] uint8
    (``vp8l_stream``)."""
    return _riff_webp([(b"VP8L", vp8l_stream(rgb))])


def _u24(v: int) -> bytes:
    return int(v).to_bytes(3, "little")


def encode_webp_animated(rgb: np.ndarray, at: tuple[int, int] = (0, 0),
                         canvas: tuple[int, int] | None = None) -> bytes:
    """Animated WebP (``VP8X``, ``ANIM``, two ``ANMF``) of two lossless
    frames on a canvas of ``canvas`` (h, w; by default just big enough):
    ``rgb`` [H,W,3] uint8 at ``at`` (x, y, both even), then its top-left
    quarter upside down at the canvas's origin.  What a reader shows
    first is ``rgb`` on a black canvas."""
    h, w, _ = rgb.shape
    ch, cw = canvas or (at[1] + h, at[0] + w)
    part = np.ascontiguousarray(rgb[:max(1, h // 2), :max(1, w // 2)][::-1])
    frames = []
    for (x, y), img in ((at, rgb), ((0, 0), part)):
        fh, fw, _ = img.shape
        stream = vp8l_stream(img)
        frames.append((b"ANMF", _u24(x // 2) + _u24(y // 2) + _u24(fw - 1)
                       + _u24(fh - 1) + _u24(100) + bytes([0x02])
                       + b"VP8L" + struct.pack("<I", len(stream)) + stream
                       + b"\0" * (len(stream) & 1)))
    vp8x = bytes([0x02, 0, 0, 0]) + _u24(cw - 1) + _u24(ch - 1)
    return _riff_webp([(b"VP8X", vp8x), (b"ANIM", bytes(6))] + frames)


def quantize_332(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``rgb`` [H,W,3] uint8 as indices into one fixed 256-entry palette
    (3 bits of red, 3 of green, 2 of blue, each entry at the middle of its
    bin) → (index [H,W] uint8, palette [256,3] uint8)."""
    c = np.asarray(rgb, np.uint8)
    index = ((c[..., 0] >> 5) << 5 | (c[..., 1] >> 5) << 2
             | c[..., 2] >> 6).astype(np.uint8)
    i = np.arange(256)
    palette = np.stack([(i >> 5) * 32 + 16, (i >> 2 & 7) * 32 + 16,
                        (i & 3) * 64 + 32], 1).astype(np.uint8)
    return index, palette


def _sub_blocks(data: bytes) -> bytes:
    """GIF data sub-blocks (255 bytes each, the last shorter) and the
    block terminator."""
    a = np.frombuffer(data, np.uint8)
    full = len(a) // 255
    body = np.concatenate([np.full((full, 1), 255, np.uint8),
                           a[:full * 255].reshape(full, 255)], 1).tobytes()
    rest = a[full * 255:].tobytes()
    return body + (bytes([len(rest)]) + rest if rest else b"") + b"\0"


def encode_gif(index: np.ndarray, palette: np.ndarray) -> bytes:
    """GIF89a of the index image ``index`` [H,W] uint8 with ``palette``
    [256,3] uint8 as its global colour table: LZW at a minimum code size of
    8 whose codes are all literals, a clear code before every 254 of them
    so that every code stays 9 bits wide, and the end code."""
    h, w = index.shape
    flat = np.asarray(index, np.int64).ravel()
    run = 254
    codes = np.empty(len(flat) + -(-len(flat) // run) + 1, np.uint64)
    i = np.arange(len(flat))
    codes[i + i // run + 1] = flat
    codes[np.arange(0, len(codes) - 1, run + 1)] = 256    # clear
    codes[-1] = 257                                       # end
    data = _pack_bits(codes, np.full(len(codes), 9))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
            + np.ascontiguousarray(palette, np.uint8).tobytes()
            + b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08"
            + _sub_blocks(data) + b"\x3b")


SUN_MAGIC = 0x59A66A95


def sun_rle(data: bytes) -> bytes:
    """Sun raster's byte run-length code (type 2): a run of n > 2 equal
    bytes (at most 256) is 0x80, n - 1, the byte; a lone 0x80 is 0x80, 0;
    every other byte stands for itself."""
    a = np.frombuffer(data, np.uint8)
    if not len(a):
        return b""
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    lengths = np.diff(np.r_[starts, len(a)])
    out = bytearray()
    for s, n in zip(starts.tolist(), lengths.tolist()):
        v = int(a[s])
        while n:
            k = min(n, 256)
            if k > 2 or (v == 0x80 and k == 2):
                out += bytes((0x80, k - 1, v))
            elif v == 0x80:
                out += b"\x80\x00"
            else:
                out += bytes([v] * k)
            n -= k
    return bytes(out)


def encode_sun_raster(samples: np.ndarray, *, depth: int = 24,
                      rle: bool = False, rgb_order: bool = False,
                      palette: np.ndarray = None) -> bytes:
    """A Sun raster file (big-endian 32-byte header, rows padded to 16
    bits) of ``samples``: [H,W,3] uint8 RGB at depth 24 or 32 (stored
    B, G, R, or R, G, B with ``rgb_order`` (type 3); at 32 bits after a
    pad byte), or [H,W] indices or gray levels at depth 1 or 8, with a
    ``palette`` [n,3] (maptype 1) or without (gray).  ``rle`` codes the
    image data with type 2's byte runs."""
    h, w = samples.shape[:2]
    pitch = (w * depth + 15) // 16 * 2
    rows = np.zeros((h, pitch), np.uint8)
    if depth == 1:
        packed = np.packbits(np.asarray(samples, np.uint8) & 1, axis=1)
        rows[:, :packed.shape[1]] = packed
    elif depth == 8:
        rows[:, :w] = samples
    else:
        px = samples if rgb_order else samples[..., ::-1]
        if depth == 32:
            px = np.concatenate([np.zeros((h, w, 1), np.uint8), px], -1)
        rows[:, :w * depth // 8] = px.reshape(h, -1)
    data = rows.tobytes()
    kind = 3 if rgb_order else 1
    if rle:
        data, kind = sun_rle(data), 2
    cmap = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        cmap = pal[:, 0].tobytes() + pal[:, 1].tobytes() + pal[:, 2].tobytes()
    return (struct.pack(">8I", SUN_MAGIC, w, h, depth, len(data), kind,
                        1 if cmap else 0, len(cmap)) + cmap + data)


def encode_pfm(rgb: np.ndarray) -> bytes:
    """A little-endian PFM (scale -1) of ``rgb`` [H,W,3] uint8 as float32
    0-255 samples, rows from the bottom up (OpenCV reads it back as
    ``rgb``)."""
    h, w, _ = rgb.shape
    return (f"PF\n{w} {h}\n-1.0\n".encode()
            + np.ascontiguousarray(rgb[::-1], "<f4").tobytes())


def rgbe(rgb: np.ndarray) -> np.ndarray:
    """[H,W,4] RGBE bytes of ``rgb`` / 255 (Radiance's float2rgbe: the
    largest channel's frexp gives the shared exponent)."""
    f = rgb.astype(np.float64) / 255.0
    m, e = np.frexp(f.max(axis=-1))
    scale = np.where(m > 1e-32, m * 256.0 / np.maximum(f.max(axis=-1),
                                                       1e-300), 0.0)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = (f * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(m > 1e-32, e + 128, 0)
    return out


def encode_hdr(rgb: np.ndarray) -> bytes:
    """A Radiance HDR file of ``rgb`` [H,W,3] uint8 / 255 as OpenCV's
    writer lays one out (``#?RGBE``, the RGBE FORMAT, ``-Y h +X w``), each
    scanline new-style: 2, 2, its width, then each channel as literal runs
    of up to 128 bytes (widths of 8 to 32767; flat RGBE otherwise)."""
    h, w, _ = rgb.shape
    px = rgbe(rgb)
    head = f"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    if not 8 <= w <= 0x7FFF:
        return head + px.tobytes()
    starts = np.arange(0, w, 128)
    counts = np.minimum(128, w - starts).astype(np.uint8)
    lines = []
    for y in range(h):
        parts = [bytes((2, 2, w >> 8, w & 0xFF))]
        for c in range(4):
            chan = px[y, :, c]
            for s, n in zip(starts.tolist(), counts.tolist()):
                parts.append(bytes((n,)) + chan[s:s + n].tobytes())
        lines.append(b"".join(parts))
    return head + b"".join(lines)
