"""CCITT bilevel coding in numpy for TIFF photos: Modified Huffman rows
(T.4 one-dimensional), T.4 two-dimensional rows and T.6 (Group 4), as
libtiff's tif_fax3.c writes them, so that a machine with no image library
can write the CCITT TIFF files it reads back.  ``strip`` codes the rows of
one strip or tile; ``testing/photos.encode_tiff`` puts them in a file."""

from __future__ import annotations

import numpy as np

# T.4 code words, first bit first: terminating codes for runs 0-63, then
# make-up codes for 64, 128, ... 1728, then the extended make-up codes for
# 1792 ... 2560 (both colours)
_TERM_W = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_MAKEUP_W = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
_TERM_B = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_MAKEUP_B = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 "
    "0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
_MAKEUP_X = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
_EOL = "000000000001"
_PASS, _HORIZ = "0001", "001"
# vertical modes by b1 - a1 = -3 ... 3 (VR3 ... V0 ... VL3)
_VERTICAL = ("0000011", "000011", "011", "1", "010", "000010", "0000010")


def _run(n: int, black: bool) -> list[str]:
    """The code words of one run of ``n`` pixels (libtiff's putspan: the
    2560 make-up code while more remain, one make-up code, then a
    terminating one)."""
    term, makeup = (_TERM_B, _MAKEUP_B) if black else (_TERM_W, _MAKEUP_W)
    out = []
    while n >= 2560 + 64:
        out.append(_MAKEUP_X[-1])
        n -= 2560
    if n >= 64:
        m = n // 64
        out.append(makeup[m - 1] if m <= 27 else _MAKEUP_X[m - 28])
        n -= 64 * m
    out.append(term[n])
    return out


def _row_1d(row: np.ndarray) -> list[str]:
    """Modified Huffman code words of one row (Fax3Encode1DRow): white
    and black runs in turn from a white one, which may be empty."""
    w = row.size
    d = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(np.int8)])))
    runs = np.diff(np.concatenate([[0], d, [w]]))
    out = []
    for i, n in enumerate(runs):
        out += _run(int(n), bool(i & 1))
    return out


def _row_2d(row: np.ndarray, ref: np.ndarray) -> list[str]:
    """T.4 two-dimensional code words of one row against the reference
    row (Fax3Encode2DRow: pass, horizontal and vertical modes)."""
    w = row.size

    def pix(buf, x):
        return int(buf[x]) if x < w else 0

    def diff(buf, x, c):         # finddiff2: the first pixel not of colour c
        return x + _span(buf, x, c) if x < w else w
    out = []
    a0 = 0
    a1 = 0 if row[0] else diff(row, 0, 0)
    b1 = 0 if ref[0] else diff(ref, 0, 0)
    while True:
        b2 = diff(ref, b1, pix(ref, b1))
        if b2 >= a1:
            d = b1 - a1
            if -3 <= d <= 3:
                out.append(_VERTICAL[d + 3])
                a0 = a1
            else:
                a2 = diff(row, a1, pix(row, a1))
                out.append(_HORIZ)
                black_first = not (a0 + a1 == 0 or pix(row, a0) == 0)
                out += (_run(a1 - a0, black_first)
                        + _run(a2 - a1, not black_first))
                a0 = a2
        else:
            out.append(_PASS)
            a0 = b2
        if a0 >= w:
            return out
        c = pix(row, a0)
        a1 = diff(row, a0, c)
        b1 = diff(ref, diff(ref, a0, c ^ 1), c)


def _span(buf: np.ndarray, x: int, c: int) -> int:
    """Pixels of colour ``c`` from x on (libtiff's find0span/find1span)."""
    rest = np.flatnonzero(buf[x:] != c)
    return int(rest[0]) if rest.size else buf.size - x


def _pack(words: list[str]) -> tuple[np.ndarray, int]:
    """Bits of the code words, first bit first, and their count."""
    bits = np.frombuffer("".join(words).encode(), np.uint8) - ord("0")
    return bits, bits.size


def strip(rows: np.ndarray, mode: str, *, eol_align: bool = False,
          k: int = 4, lsb_first: bool = False) -> bytes:
    """One strip of ``rows`` [R, W] (1 a set bit: black where the image is
    MinIsWhite) coded as ``mode``: "rle" (compression 2: each row from a
    byte boundary), "rlew" (32771: from a 16-bit one), "g3" (T.4 1D rows
    each after an EOL), "g3_2d" (T.4 rows after an EOL and its tag bit,
    every ``k``-th row 1D, the others 2D), "g4" (T.6, then EOFB).
    ``eol_align``: fill bits so each EOL ends on a byte boundary (T4Options
    bit 2).  ``lsb_first``: FillOrder 2."""
    rows = np.asarray(rows, np.uint8) & 1
    pieces: list[np.ndarray] = []
    at = 0

    def put(words):
        nonlocal at
        bits, n = _pack(words)
        pieces.append(bits)
        at += n

    def pad_to(multiple):
        nonlocal at
        extra = -at % multiple
        if extra:
            pieces.append(np.zeros(extra, np.uint8))
            at += extra

    ref = np.zeros(rows.shape[1], np.uint8)
    for i, row in enumerate(rows):
        if mode in ("g3", "g3_2d"):
            if eol_align:           # EOL to end where a byte ends
                extra = (4 - at) % 8
                if extra:
                    pieces.append(np.zeros(extra, np.uint8))
                    at += extra
            one_d = mode == "g3" or i % k == 0
            put([_EOL] + (["1" if one_d else "0"] if mode == "g3_2d"
                          else []))
            put(_row_1d(row) if one_d else _row_2d(row, ref))
        elif mode == "g4":
            put(_row_2d(row, ref))
        else:
            put(_row_1d(row))
            pad_to(8 if mode == "rle" else 16)
        ref = row
    if mode == "g4":
        put([_EOL, _EOL])
    bits = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    data = np.packbits(bits, bitorder="little" if lsb_first else "big")
    return data.tobytes()
