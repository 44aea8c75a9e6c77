"""Writers of test photos in numpy and the standard library, for machines
with no image encoder: binary PPM (P6), 24-bit BMP, TIFF (none, Deflate
or PackBits compression, with or without the horizontal predictor, in
strips or tiles, chunky or planar, 8 or 16-bit, either byte order, classic
or BigTIFF, with an Orientation tag), 16-bit RGB PNG and 8-bit PNG with
every row filtered Paeth, and an EXIF APP1 segment put into a JPEG.  Each
``encode_*`` returns the file's bytes."""

from __future__ import annotations

import struct
import zlib

import numpy as np

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


def encode_tiff(samples: np.ndarray, *, photometric: int = 2,
                compression: str = "none", predictor: int = 1,
                rows_per_strip: int | None = None,
                tile: tuple[int, int] | None = None, planar: bool = False,
                big_endian: bool = False, bigtiff: bool = False,
                orientation: int | None = None,
                extra_samples: tuple[int, ...] = (),
                colormap: np.ndarray | None = None) -> bytes:
    """TIFF of ``samples`` [H,W,spp] (uint8 or uint16; [H,W] for one
    sample) with ``compression`` "none", "deflate" (8) or "packbits", the
    horizontal predictor where ``predictor`` is 2, in strips of
    ``rows_per_strip`` rows (default: one strip) or in tiles of ``tile`` =
    (width, height), chunky or ``planar``; ``colormap`` [3, 2^bits] for a
    palette image (``photometric`` 3)."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    h, w, spp = s.shape
    bits = 16 if s.dtype == np.uint16 else 8
    e = ">" if big_endian else "<"
    dtype = np.dtype(e + "u2") if bits == 16 else np.dtype(np.uint8)
    if tile is not None:
        cw, ch = tile
        across, down = -(-w // cw), -(-h // ch)
        padded = np.zeros((down * ch, across * cw, spp), s.dtype)
        padded[:h, :w] = s
    else:
        cw, ch = w, min(rows_per_strip or h, h)
        across, down = 1, -(-h // ch)
        padded = s
    code = {"none": 1, "deflate": 8, "packbits": 32773}[compression]
    chunks = []
    for plane in range(spp if planar else 1):
        for ty in range(down):
            for tx in range(across):
                block = padded[ty * ch:(ty + 1) * ch, tx * cw:(tx + 1) * cw]
                if planar:
                    block = block[:, :, plane:plane + 1]
                if predictor == 2:
                    block = _differenced(block)
                raw = np.ascontiguousarray(block).astype(dtype).tobytes()
                if code == 8:
                    raw = zlib.compress(raw, 6)
                elif code == 32773:
                    raw = _packbits(raw)
                chunks.append(raw)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [code]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [2 if planar else 1])]
    if predictor == 2:
        entries.append((317, 3, [2]))
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
    entries.sort()
    codes = {3: "H", 4: "I", 16: "Q"}
    sizes = {3: 2, 4: 4, 16: 8}
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
        head_fields = struct.pack(e + "HH" + word, tag, ftype, len(values))
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
