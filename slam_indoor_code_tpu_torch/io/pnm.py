"""Netpbm photos (PBM, PGM, PPM: P1-P6; PAM: P7) in numpy, to the pixels
OpenCV's own PxM and PAM decoders give ``imread`` in colour:

- binary samples are kept as stored, whatever the maxval (a P6 of maxval
  100 is not stretched to 255); ASCII samples above the maxval are cut to
  it and, at a maxval below 256, scaled by ``v * 255 // maxval``;
- a maxval above 255 makes 16-bit samples, of which the high byte is kept
  (``v >> 8``), binary (big-endian) or ASCII;
- bitmaps (P1, P4) are white where a bit is 0 and black where it is 1;
  P1's digits may run together;
- comments (``#`` to the end of the line) may stand between header numbers,
  and the last ASCII sample must be followed by a byte, as OpenCV reads
  one past each number;
- gray is repeated into three channels;
- PAM: the header's WIDTH, HEIGHT, DEPTH, MAXVAL and TUPLTYPE (one of
  BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA, RGB, RGB_ALPHA; without it
  only depth 1, or depth 3 at a maxval below 256, opens); a three-sample
  PAM's samples come out in the file's order as OpenCV's blue, green and
  red, so its red and blue trade places, as in cv2; a PAM of maxval 1
  is read as OpenCV reads it, one bit per pixel from the row's sample
  bytes, most significant bit first, white where set.  A PAM with alpha
  gives its gray or RGB and drops the alpha (OpenCV 5.0 converts only part
  of each such row and leaves the rest unwritten).

A header or sample OpenCV refuses, and data that ends early, raise
``ValueError``.
"""

from __future__ import annotations

import re

import numpy as np

_SPACE = b" \t\n\v\f\r"
_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]")
_INT_MAX = 2**31 - 1
_PAM_TYPES = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB",
              "RGB_ALPHA")


def _read_number(data: bytes, pos: int) -> tuple[int, int]:
    """OpenCV's ``ReadNumber``: skip white space and comments, read the
    digits and the one byte after them → (value, position after it)."""
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("PNM: header ends early")
        c = data[pos]
        pos += 1
        if 48 <= c <= 57:
            break
        if c == 35:                                  # '#': to end of line
            while pos < n and data[pos] not in b"\r\n":
                pos += 1
            pos += 1
        elif c not in _SPACE:
            raise ValueError(f"PNM: unexpected byte {c:#x} in the header")
    value = c - 48
    while pos < n and 48 <= data[pos] <= 57:
        value = value * 10 + data[pos] - 48
        if value > _INT_MAX:
            raise ValueError("PNM: number too large")
        pos += 1
    if pos >= n:
        raise ValueError("PNM: data ends early")
    return value, pos + 1


def _bits_to_rgb(rows: np.ndarray, w: int, set_value: int) -> np.ndarray:
    """[H, >= ceil(w/8)] bytes, one bit per pixel most significant first,
    to HxWx3: ``set_value`` where the bit is 1, 255 - it where 0."""
    bits = np.unpackbits(rows, axis=1)[:, :w]
    gray = np.where(bits == 1, set_value, 255 - set_value).astype(np.uint8)
    return np.repeat(gray[:, :, None], 3, axis=2)


def _ascii_samples(data: bytes, count: int, single_digits: bool
                   ) -> np.ndarray:
    text = _COMMENT.sub(b" ", data)
    if text.translate(None, b"0123456789" + _SPACE):
        raise ValueError("PNM: unexpected byte among the samples")
    if single_digits:                 # P1: one digit per sample
        digits = text.translate(None, _SPACE)
        if len(digits) < count:
            raise ValueError("PNM: data ends early")
        return np.frombuffer(digits, np.uint8, count) - 48
    tokens = text.split(None, count)
    if len(tokens) < count or (len(tokens) == count
                               and text[-1:] not in _SPACE):
        raise ValueError("PNM: data ends early")
    try:
        values = np.array(tokens[:count], dtype=np.int64)
    except OverflowError as e:
        raise ValueError("PNM: number too large") from e
    if values.size and values.max() > _INT_MAX:
        raise ValueError("PNM: number too large")
    return values


def _decode_pnm(data: bytes, kind: int) -> np.ndarray:
    w, pos = _read_number(data, 2)
    h, pos = _read_number(data, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _read_number(data, pos)
    if not (w > 0 and h > 0 and 0 < maxval < 65536):
        raise ValueError(f"PNM: {w}x{h}, maxval {maxval}")
    ch = 3 if kind in (3, 6) else 1
    if kind == 4:
        pitch = (w + 7) // 8
        if len(data) - pos < pitch * h:
            raise ValueError("PNM: data ends early")
        rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
        return _bits_to_rgb(rows, w, 0)
    if kind == 1:
        bits = _ascii_samples(data[pos:], w * h, True) != 0
        return _bits_to_rgb(np.packbits(bits.reshape(h, w), axis=1), w, 0)
    wide = maxval > 255
    if kind in (2, 3):
        v = np.minimum(_ascii_samples(data[pos:], w * h * ch, False), maxval)
        v = v >> 8 if wide else v * 255 // maxval
        img = v.astype(np.uint8).reshape(h, w, ch)
    else:
        size = w * h * ch * (2 if wide else 1)
        if len(data) - pos < size:
            raise ValueError("PNM: data ends early")
        img = np.frombuffer(data, np.uint8, size, pos)
        img = (img[0::2] if wide else img).reshape(h, w, ch)
    return img if ch == 3 else np.repeat(img, 3, axis=2)


def _decode_pam(data: bytes) -> np.ndarray:
    if data[2:3] not in (b"\r", b"\n"):
        raise ValueError("PAM: bad signature")
    fields: dict = {}
    pos = 3
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise ValueError("PAM: header ends early")
        line = data[pos:end].strip()
        pos = end + 1
        if not line or line.startswith(b"#"):
            continue
        key, _, value = line.partition(b" ")
        key, value = key.decode(errors="replace"), value.strip()
        if key == "ENDHDR":
            break
        if key not in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE") \
                or key in fields:
            raise ValueError(f"PAM: header field {key!r}")
        if key == "TUPLTYPE":
            fields[key] = value.decode(errors="replace")
            if fields[key] not in _PAM_TYPES:
                raise ValueError(f"PAM: tuple type {fields[key]!r}")
        elif not value.isdigit():
            raise ValueError(f"PAM: {key} {value!r}")
        else:
            fields[key] = int(value)
    try:
        w, h, ch, maxval = (fields[k] for k in ("WIDTH", "HEIGHT", "DEPTH",
                                                 "MAXVAL"))
    except KeyError as e:
        raise ValueError(f"PAM: no {e.args[0]}") from e
    kind = fields.get("TUPLTYPE")
    if kind is None and not (ch == 1 or (ch == 3 and maxval < 256)):
        raise ValueError(f"PAM: depth {ch} at maxval {maxval} without a "
                         "tuple type")
    if not (w > 0 and h > 0 and 1 <= ch <= 4 and 0 < maxval < 65536):
        raise ValueError(f"PAM: {w}x{h}x{ch}, maxval {maxval}")
    wide = maxval > 255
    size = w * h * ch * (2 if wide else 1)
    if len(data) - pos < size:
        raise ValueError("PAM: data ends early")
    samples = np.frombuffer(data, np.uint8, size, pos)
    if maxval == 1:
        return _bits_to_rgb(samples.reshape(h, -1), w, 255)
    img = (samples[0::2] if wide else samples).reshape(h, w, ch)
    if ch <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1] if ch == 3 else img[..., :3])


def decode(data: bytes) -> np.ndarray:
    """HxWx3 uint8 RGB of the Netpbm ``data`` (P1-P7)."""
    if len(data) < 3 or data[:1] != b"P" or data[1] not in b"1234567":
        raise ValueError("not a Netpbm file")
    if data[1] == ord("7"):
        return _decode_pam(data)
    return _decode_pnm(data, data[1] - 48)
