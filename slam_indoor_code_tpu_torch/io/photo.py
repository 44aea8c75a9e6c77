"""One photo file to HxWx3 uint8 RGB without OpenCV, as ``cv2.imread``
gives it in colour: the format found by its first bytes, as OpenCV finds
it, then decoded by the port's own reader (JPEG: io/jpeg.py; PNG:
io/png.py; BMP: io/bmp.py; PBM/PGM/PPM/PAM: io/pnm.py; TIFF, with
JPEG-compressed, YCbCr, CMYK and CIE Lab images: io/tiff.py; JPEG 2000,
JP2 or J2K: io/jp2.py; lossy, lossless and animated WebP: io/webp.py;
GIF: io/gif.py; PFM: io/pfm.py; Radiance HDR: io/hdr.py; Sun raster:
io/sunras.py), and turned by the EXIF orientation where OpenCV turns it
(io/exif.py: a JPEG's APP1, a PNG's ``eXIf``, a WebP's ``EXIF``; a TIFF's
own Orientation tag in io/tiff.py).

Three outcomes besides a frame:

- a format that OpenCV reads and the port does not yet (AVIF; CCITT,
  old-style JPEG and the other TIFF compressions io/tiff.py names; JPEG
  2000 code-block styles and HTJ2K) raises ``NotImplementedError`` naming
  it, which the photo sequence passes on to its caller;
- a damaged file of a format the port reads gives what OpenCV's reader
  gives for it: a JPEG as libjpeg-turbo recovers it (io/jpeg.py's
  ``lenient``), a TIFF strip as libtiff leaves it, or None (and the file
  is skipped) where ``imread`` gives an empty image;
- bytes that are no image OpenCV knows give None too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import (bmp, exif, gif, hdr, jp2, jpeg, pfm, png, pnm, sunras, tiff,
               webp)

_SPACE = b" \t\n\v\f\r"


def _refused(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} photos are not read by the port")


def sniff(head: bytes) -> Optional[str]:
    """The format of a file that starts with ``head`` (its first 32 bytes
    or more): "jpeg", "png", "bmp", "pnm", "tiff", "jp2", "webp", "gif",
    "pfm", "hdr" or "sunras"; None for bytes that are no image OpenCV
    reads.  Raises ``NotImplementedError`` for a format OpenCV reads that
    the port does not."""
    if head.startswith(jp2.MAGICS):
        return "jp2"
    if head[4:8] == b"ftyp" and (b"avif" in head[8:32]
                                 or b"avis" in head[8:32]):
        raise _refused("AVIF")
    if head[:2] in (b"PF", b"Pf") and head[2:3] and head[2] in _SPACE:
        return "pfm"
    if head.startswith(hdr.MAGICS):
        return "hdr"
    if head[:4] == sunras.MAGIC:
        return "sunras"
    if head[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if head[:8] == png.SIGNATURE:
        return "png"
    if head[:2] == b"BM":
        return "bmp"
    if (head[:1] == b"P" and head[1:2] and head[1] in b"1234567"
            and head[2:3] and head[2] in _SPACE):
        return "pnm"
    if head[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return "tiff"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    if head[:6] in gif.MAGICS:
        return "gif"
    return None


def decode(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the photo ``data``, EXIF orientation applied
    where OpenCV applies it; None for a damaged file or bytes that are no
    image; ``NotImplementedError`` naming a format the port does not read
    (``ValueError`` naming a JPEG process io/jpeg.py does not read)."""
    kind = sniff(data[:32])
    if kind is None:
        return None
    if kind == "jpeg":
        img = jpeg.decode(data, lenient=True)
        block = exif.jpeg_block(data) if img is not None else None
    else:
        try:
            if kind == "png":
                img, block = png.decode(data), png.exif(data)
            elif kind == "webp":
                img, block = webp.decode(data)
            elif kind == "tiff":
                img, block = tiff.decode(data), None
            elif kind == "jp2":
                img, block = jp2.decode(data), None
            elif kind == "gif":
                img, block = gif.decode(data), None
            elif kind in ("pfm", "hdr", "sunras"):
                img = {"pfm": pfm, "hdr": hdr, "sunras": sunras}[kind].decode(
                    data)
                block = None
            else:
                img, block = (bmp if kind == "bmp" else pnm).decode(data), None
        except ValueError:
            return None
    if img is None:
        return None
    return exif.apply(img, exif.orientation(block))


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """Decode one photo file (see ``decode``)."""
    with open(path, "rb") as fh:
        return decode(fh.read())
