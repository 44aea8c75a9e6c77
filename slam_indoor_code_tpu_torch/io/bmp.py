"""BMP photos in numpy, to the pixels OpenCV's own BMP decoder gives
``imread`` in colour:

- the core (OS/2 1.x, 12-byte), INFO (40-byte) and larger (V4, V5, OS/2
  2.x) headers; OpenCV reads BITFIELDS masks from the bytes after the
  header, whatever its size;
- 1, 4 and 8-bit palette images (a palette of ``biClrUsed`` entries, or
  of 2^bits where that is 0; indices past it are black), RLE4 and RLE8
  with their end-of-line, end-of-bitmap and delta escapes (the pixels
  they pass over take palette entry 0, as in OpenCV);
- 16-bit 555 (BI_RGB, or BITFIELDS with 555 masks) and 565 (BITFIELDS),
  each field shifted up with its low bits zero;
- 24-bit, and 32-bit (BI_RGB or BITFIELDS: the first three bytes of each
  pixel are blue, green and red, whatever the masks say);
- bottom-up rows (a positive height) and top-down ones (negative).

A header OpenCV refuses, a run that leaves its row, and data that ends
early raise ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .png import MAX_PIXELS

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7C00, 0x3E0, 0x1F)
_MASKS_565 = (0xF800, 0x7E0, 0x1F)


class _Header:
    """What OpenCV's ``BmpDecoder::readHeader`` takes from a file."""

    def __init__(self, data: bytes):
        if data[:2] != b"BM":
            raise ValueError("not a BMP file")
        self.offset, size = _unpack(data, "<iI", 10)
        self.palette = np.zeros((256, 3), np.uint8)      # RGB
        if size >= 36:
            w, h, bpp, comp, clrused = _unpack(data, "<iiII12xi", 18)
            bpp >>= 16
            ok = (w > 0 and h != 0 and (
                (bpp in (1, 4, 8, 24, 32) and comp == _RGB)
                or (bpp in (16, 32) and comp in (_RGB, _BITFIELDS))
                or (bpp == 4 and comp == _RLE4)
                or (bpp == 8 and comp == _RLE8)))
            if not ok:
                raise ValueError(f"BMP: {bpp}-bit, compression {comp}")
            at = 14 + size
            if bpp <= 8:
                if not 0 <= clrused <= 256:
                    raise ValueError(f"BMP: {clrused} palette entries")
                n = clrused or 1 << bpp
                self._palette(data, at, n, 4)
            elif bpp == 16 and comp == _BITFIELDS:
                masks = _unpack(data, "<III", at)
                if masks == _MASKS_555:
                    bpp = 15
                elif masks != _MASKS_565:
                    raise ValueError(f"BMP: 16-bit masks {masks}")
            elif bpp == 16:
                bpp = 15
        elif size == 12:
            w, h, planes, bpp = _unpack(data, "<HHHH", 18)
            if planes != 1 or not (w > 0 and h != 0
                                   and bpp in (1, 4, 8, 24, 32)):
                raise ValueError(f"BMP: core header {w}x{h}, {bpp}-bit")
            comp = _RGB
            if bpp <= 8:
                self._palette(data, 26, 1 << bpp, 3)
        else:
            raise ValueError(f"BMP: a {size}-byte header")
        if w * abs(h) * 3 >= MAX_PIXELS:             # OpenCV's BMP limit
            raise ValueError(f"BMP: {w}x{abs(h)} is too large")
        self.w, self.h, self.bpp, self.comp = w, abs(h), bpp, comp
        self.bottom_up = h > 0

    def _palette(self, data: bytes, at: int, n: int, entry: int) -> None:
        if at + n * entry > len(data):
            raise ValueError("BMP: palette cut short")
        bgr = np.frombuffer(data, np.uint8, n * entry, at).reshape(n, entry)
        self.palette[:n] = bgr[:, 2::-1]


def _unpack(data: bytes, fmt: str, at: int) -> tuple:
    try:
        return struct.unpack_from(fmt, data, at)
    except struct.error as e:
        raise ValueError("BMP: header cut short") from e


class _RleCanvas:
    """OpenCV's RLE writing position: row ``y`` (in file order), column
    ``x``; ``fill`` is its ``FillUniColor``, which runs on into the
    following rows."""

    def __init__(self, w: int, h: int):
        self.idx = np.zeros((h, w), np.uint8)        # palette indices
        self.w, self.h, self.x, self.y = w, h, 0, 0

    def fill(self, count: int, index: int) -> None:
        while True:
            n = max(0, min(count, self.w - self.x))
            self.idx[self.y, self.x:self.x + n] = index
            self.x += n
            count -= n
            if self.x >= self.w:
                self.x, self.y = 0, self.y + 1
                if self.y >= self.h:
                    return
            if count <= 0:
                return

    def put(self, indices) -> None:
        self.idx[self.y, self.x:self.x + len(indices)] = indices
        self.x += len(indices)


def _rle(data: bytes, pos: int, w: int, h: int, four: bool) -> np.ndarray:
    """Palette indices [h, w] (file row order) of RLE8 or RLE4 data, as
    OpenCV's decoder lays them down."""
    c = _RleCanvas(w, h)
    line_end_flag = 0
    n = len(data)
    while True:
        if pos + 2 > n:
            raise ValueError("BMP: RLE data ends early")
        count, code = data[pos], data[pos + 1]
        pos += 2
        if count:                                    # encoded run
            if c.x + count > w:
                raise ValueError("BMP: an RLE run leaves its row")
            prev_y = c.y
            if four:
                c.put([code >> 4 if i % 2 == 0 else code & 15
                       for i in range(count)])
            else:
                c.fill(count, code)
            line_end_flag = c.y - prev_y
            if c.y >= h:
                break
        elif code > 2:                               # absolute run
            if c.x + code > w:
                raise ValueError("BMP: an RLE run leaves its row")
            size = (((code + 1) >> 1) + 1) & ~1 if four else (code + 1) & ~1
            if pos + size > n:
                raise ValueError("BMP: RLE data ends early")
            raw = data[pos:pos + size]
            pos += size
            if four:
                c.put([raw[i >> 1] >> 4 if i % 2 == 0 else raw[i >> 1] & 15
                       for i in range(code)])
            else:
                c.put(list(raw[:code]))
            line_end_flag = 0
        else:                                        # escape
            x_shift, y_shift = w - c.x, h - c.y
            if four or code or not line_end_flag or x_shift < w:
                if code == 2:
                    if pos + 2 > n:
                        raise ValueError("BMP: RLE data ends early")
                    x_shift, y_shift = data[pos], data[pos + 1]
                    pos += 2
                if code:
                    x_shift += y_shift * w
                if c.y >= h:
                    break
                c.fill(x_shift, 0)
                if c.y >= h:
                    break
            line_end_flag = 0
            if c.y >= h:
                break
    return c.idx


def decode(data: bytes) -> np.ndarray:
    """HxWx3 uint8 RGB of the BMP ``data``."""
    hd = _Header(data)
    w, h, bpp = hd.w, hd.h, hd.bpp
    if hd.offset < 0:
        raise ValueError("BMP: negative data offset")
    if hd.comp in (_RLE8, _RLE4):
        img = hd.palette[_rle(data, hd.offset, w, h, hd.comp == _RLE4)]
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        if hd.offset + pitch * h > len(data):
            raise ValueError("BMP: data ends early")
        rows = np.frombuffer(data, np.uint8, pitch * h,
                             hd.offset).reshape(h, pitch)
        if bpp <= 8:
            if bpp < 8:
                bits = np.unpackbits(rows, axis=1)
                bits = bits.reshape(h, -1, bpp)[:, :w]
                weights = 1 << np.arange(bpp - 1, -1, -1, dtype=np.uint8)
                idx = (bits * weights).sum(axis=2, dtype=np.uint8)
            else:
                idx = rows[:, :w]
            img = hd.palette[idx]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].copy().view("<u2").astype(np.uint16)
            if bpp == 15:
                b, g, r = t << 3, t >> 2, t >> 7
                img = np.stack([r, g, b], axis=2) & 0xF8
            else:
                img = np.stack([(t >> 8) & 0xF8, (t >> 3) & 0xFC,
                                (t << 3) & 0xF8], axis=2)
            img = img.astype(np.uint8)
        else:
            step = bpp // 8
            img = rows[:, :w * step].reshape(h, w, step)[:, :, 2::-1]
    if hd.bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img)
