"""EXIF orientation, applied to a photo as OpenCV's ``imread`` applies it
(imgcodecs' ``ExifReader`` and ``ApplyExifOrientation``): the Orientation
tag (0x0112) of the first image directory of a TIFF-structured EXIF
block, in either byte order, its value read as a 16-bit number whatever
the entry's type; 1 (as stored) where the block has no such tag, does not
parse, or holds a value outside 1..8.  OpenCV reads the block from a
JPEG's ``Exif`` APP1 segment, a PNG's ``eXIf`` chunk and a WebP's ``EXIF``
chunk; a TIFF's own Orientation tag is read by io/tiff.py.  Motion-JPEG
video frames are not oriented, as OpenCV's video readers do not.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

ORIENTATION = 0x0112


def orientation(block: Optional[bytes]) -> int:
    """The orientation (1..8) that the EXIF ``block`` (a TIFF header
    first) asks for; 1 where it gives none."""
    if not block or len(block) < 8 or block[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if block[:2] == b"II" else ">"
    try:
        ifd = struct.unpack_from(e + "I", block, 4)[0]
        (count,) = struct.unpack_from(e + "H", block, ifd)
        for k in range(count):
            at = ifd + 2 + 12 * k
            if struct.unpack_from(e + "H", block, at)[0] == ORIENTATION:
                value = struct.unpack_from(e + "H", block, at + 8)[0]
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def apply(img: np.ndarray, value: int) -> np.ndarray:
    """``img`` turned as OpenCV turns a photo of EXIF orientation
    ``value``: 2 mirrors it left to right, 3 turns it half round, 4
    mirrors it top to bottom, 5 transposes it, 6 turns it a quarter
    clockwise, 7 transposes it across the other diagonal and 8 turns it a
    quarter anticlockwise."""
    if value == 2:
        img = img[:, ::-1]
    elif value == 3:
        img = img[::-1, ::-1]
    elif value == 4:
        img = img[::-1]
    elif value >= 5:
        img = img.transpose(1, 0, 2)
        img = {5: img, 6: img[:, ::-1], 7: img[::-1, ::-1],
               8: img[::-1]}[value]
    else:
        return img
    return np.ascontiguousarray(img)


def jpeg_block(data: bytes) -> Optional[bytes]:
    """The EXIF block (after ``Exif\\0\\0``) of the first such APP1 segment
    among a JPEG's markers before its first scan, or None."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:                       # fill byte
            pos += 1
            continue
        if marker == 0xDA or marker == 0xD9:     # SOS, EOI
            return None
        (n,) = struct.unpack_from(">H", data, pos + 2)
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\0\0":
            return data[pos + 10:pos + 2 + n]
        pos += 2 + n
    return None
