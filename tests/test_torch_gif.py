"""The port's GIF reading (io/gif.py over native/gif.cpp) against
``cv2.imread`` bit for bit on the CPU, with OpenCV 5.0's own GIF decoder
as the reference: cv2's and Pillow's GIFs (adaptive palettes, interlaced,
with transparency, animated); files built here for what those writers do
not make: a first image at an offset inside a larger screen, a local
colour table, the transparency index against the background index,
every disposal method, no colour table at all, LZW minimum code sizes
2-11, a table that fills to 4096 entries with a clear code that comes
late, end codes inside the data, codes past the table, too few or too
many pixels, and truncation; the numpy writer of testing/photos.py; and
slam_main on a 14-photo glob of GIFs against the JAX package's."""

import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.testing import photos
from test_torch_photos import (_photo_cfg, no_native,  # noqa: F401
                               pil_bytes, same_as_cv2, scene_image)

torch.set_num_threads(1)

RNG = np.random.default_rng(1)
PALETTE = RNG.integers(0, 256, (256, 3), np.uint8)
LOCAL = RNG.integers(0, 256, (256, 3), np.uint8)
INDEX = RNG.integers(0, 256, (20, 30), np.uint8)


def lzw(index: np.ndarray, min_code: int = 8, defer: int = 0,
        end: bool = True) -> list:
    """LZW codes (code, width) of ``index`` as a GIF encoder makes them:
    a clear code first, the table grown to 4096 entries, then a clear
    code ``defer`` codes later."""
    clear = 1 << min_code

    def reset():
        return ({bytes([i]): i for i in range(clear)}, clear + 2,
                min_code + 1)

    table, nxt, width = reset()
    out, w, full = [(clear, width)], b"", 0
    for b in np.asarray(index, np.uint8).ravel().tobytes():
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        out.append((table[w], width))
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            full += 1
            if full > defer:
                out.append((clear, width))
                table, nxt, width = reset()
                full = 0
        w = bytes([b])
    if w:
        out.append((table[w], width))
    if end:
        out.append((clear + 1, width))
    return out


def literal_codes(index: np.ndarray, min_code: int = 8) -> list:
    """Codes that are all literals, a clear code before every group of
    them that keeps the width at ``min_code`` + 1, and the end code."""
    clear, width = 1 << min_code, min_code + 1
    run = (1 << width) - clear - 2
    flat = np.asarray(index).ravel().tolist()
    out = []
    for i in range(0, len(flat), run):
        out += [(clear, width)] + [(v, width) for v in flat[i:i + run]]
    return out + [(clear + 1, width)]


def packed(codes) -> bytes:
    bits = nbits = 0
    out = bytearray()
    for code, width in codes:
        bits |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(bits & 255)
            bits >>= 8
            nbits -= 8
    if nbits:
        out.append(bits & 255)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def table_bits(table) -> tuple[int, bytes]:
    """(size field, the table padded to its power of two)."""
    k = max(0, int(np.ceil(np.log2(len(table)))) - 1)
    t = np.zeros((2 << k, 3), np.uint8)
    t[:len(table)] = table
    return k, t.tobytes()


def gif(screen, images, palette=PALETTE, bg=5, version=b"GIF89a") -> bytes:
    """A GIF of the screen (h, w) and ``images``: dicts with ``index``
    and optionally ``at`` (x, y), ``local`` (a colour table),
    ``interlace``, ``trans`` (transparency index), ``disposal``,
    ``min_code`` (8) and ``codes`` (LZW codes; default ``lzw``)."""
    out = bytearray(version + struct.pack("<HH", screen[1], screen[0]))
    if palette is None:
        out += bytes([0, bg, 0])
    else:
        k, t = table_bits(palette)
        out += bytes([0x80 | 0x70 | k, bg, 0]) + t
    for im in images:
        if "trans" in im or "disposal" in im:
            t = im.get("trans")
            out += b"\x21\xf9\x04" + bytes(
                [(t is not None) | im.get("disposal", 0) << 2, 0, 0, t or 0,
                 0])
        idx = np.asarray(im["index"])
        h, w = idx.shape
        x, y = im.get("at", (0, 0))
        flags = 0x40 if im.get("interlace") else 0
        local = b""
        if im.get("local") is not None:
            k, local = table_bits(im["local"])
            flags |= 0x80 | k
        rows = idx
        if im.get("interlace"):
            rows = idx[list(range(0, h, 8)) + list(range(4, h, 8))
                       + list(range(2, h, 4)) + list(range(1, h, 2))]
        mc = im.get("min_code", 8)
        codes = im.get("codes") or lzw(rows, mc)
        out += (b"\x2c" + struct.pack("<HHHHB", x, y, w, h, flags) + local
                + bytes([mc]) + sub_blocks(packed(codes)))
    return bytes(out + b"\x3b")


# ------------------------------------------------------- cv2 and Pillow
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (37, 53), (61, 77)])
def test_cv2s_gif_writer_equals_cv2(tmp_path, hw):
    """OpenCV's own GIF encoder (its palette and LZW)."""
    rgb = scene_image(*hw)
    same_as_cv2(tmp_path, cv2.imencode(".gif", rgb[..., ::-1])[1].tobytes())


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
@pytest.mark.parametrize("kind", ["plain", "interlaced", "transparent",
                                  "animated"])
def test_pillows_gifs_equal_cv2(tmp_path, colours, kind):
    """Pillow's GIFs (minimum code size from the palette: 2 for 2 and 4
    colours), interlaced, with a transparency index and background index,
    and animated (the first frame)."""
    rgb = scene_image(61, 77)
    q = Image.fromarray(rgb).quantize(colours)
    if kind == "animated":
        other = Image.fromarray(rgb[::-1].copy()).quantize(colours)
        data = pil_bytes(q, "GIF", save_all=True, append_images=[other],
                         duration=100, loop=0)
    elif kind == "transparent":
        data = pil_bytes(q, "GIF", transparency=1, background=0)
    else:
        data = pil_bytes(q, "GIF", interlace=kind == "interlaced")
    got = same_as_cv2(tmp_path, data)
    if kind in ("plain", "interlaced", "animated"):
        np.testing.assert_array_equal(got, np.asarray(q.convert("RGB")))


# ------------------------------------------------------- built here
@pytest.mark.parametrize("disposal", range(4))
@pytest.mark.parametrize("trans", [None, 3, 5])
def test_offset_image_transparency_and_background_equal_cv2(
        tmp_path, disposal, trans):
    """A 20x30 first image at (7, 9) on a 40x50 screen: the screen is the
    global table's background entry (index 5), and so are the pixels of
    the transparency index, whatever the disposal method."""
    data = gif((40, 50), [dict(index=INDEX, at=(7, 9), trans=trans,
                               disposal=disposal)])
    got = same_as_cv2(tmp_path, data)
    want = np.broadcast_to(PALETTE[5], (40, 50, 3)).copy()
    shown = PALETTE[INDEX]
    if trans is not None:
        shown[INDEX == trans] = PALETTE[5]
    want[9:29, 7:37] = shown
    np.testing.assert_array_equal(got, want)


def test_colour_tables_equal_cv2(tmp_path):
    """A local table over the global one; a local table alone (the screen
    black); no table at all (index i is gray i, save 1, white); a small
    global table
    with a 256-entry local one; 2- and 4-entry tables; a background index
    past the global table, and an index past the image's table, give
    None; a transparency index past it is only transparent."""
    i4 = RNG.integers(0, 4, (20, 30), np.uint8)
    bigger = i4.copy()
    bigger[0, 0] = 4
    cases = [
        gif((20, 30), [dict(index=INDEX, local=LOCAL)]),
        gif((40, 50), [dict(index=INDEX, at=(7, 9), local=LOCAL, trans=3)],
            palette=None),
        gif((20, 30), [dict(index=INDEX)], palette=None),
        gif((40, 50), [dict(index=INDEX, at=(7, 9), local=LOCAL, trans=3)],
            palette=PALETTE[:8]),
        gif((20, 30), [dict(index=i4 % 2, min_code=2)], palette=PALETTE[:2],
            bg=1),
        gif((20, 30), [dict(index=i4, min_code=2)], palette=PALETTE[:4],
            bg=1),
        gif((20, 30), [dict(index=i4, min_code=2, trans=2)],
            palette=PALETTE[:4], bg=9),
        gif((20, 30), [dict(index=INDEX)], palette=PALETTE[:4], bg=1),
        gif((20, 30), [dict(index=bigger, min_code=3, trans=4)],
            palette=PALETTE[:4], bg=1),
    ]
    got = [same_as_cv2(tmp_path, data) for data in cases]
    assert [g is None for g in got] == [False] * 6 + [True, True, False]
    np.testing.assert_array_equal(got[0], LOCAL[INDEX])
    gray = np.repeat(INDEX[..., None], 3, -1)
    gray[INDEX == 1] = 255
    np.testing.assert_array_equal(got[2], gray)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (8, 9), (20, 30), (33, 7)])
def test_interlaced_rows_equal_cv2(tmp_path, hw, interlace):
    """Interlaced rows in their four passes, at heights that leave passes
    empty."""
    index = RNG.integers(0, 256, hw, np.uint8)
    got = same_as_cv2(tmp_path, gif(hw, [dict(index=index,
                                              interlace=interlace)]))
    np.testing.assert_array_equal(got, PALETTE[index])


@pytest.mark.parametrize("min_code", range(2, 12))
def test_lzw_code_sizes_equal_cv2(tmp_path, min_code):
    """Minimum code sizes 2-8 with real LZW codes, and 2-11 with literal
    codes; 1 and 12 give None."""
    index = RNG.integers(0, 1 << min(min_code, 8), (30, 40), np.uint8)
    cases = [gif((30, 40), [dict(index=index, min_code=min_code,
                                 codes=literal_codes(index, min_code))])]
    if min_code <= 8:
        cases.append(gif((30, 40), [dict(index=index, min_code=min_code)]))
    for data in cases:
        np.testing.assert_array_equal(same_as_cv2(tmp_path, data),
                                      PALETTE[index])
    for bad in (1, 12):
        assert same_as_cv2(tmp_path, gif((30, 40), [dict(
            index=index % 2, min_code=bad,
            codes=literal_codes(index % 2, 2))])) is None


@pytest.mark.parametrize("defer", [0, 1, 100, 3000])
def test_full_table_and_a_late_clear_equal_cv2(tmp_path, defer):
    """150x200 pixels of 16 colours fill the table to 4096 entries; the
    clear code comes at once, or ``defer`` codes later (the table stays
    full and the codes 12 bits wide meanwhile)."""
    index = RNG.integers(0, 16, (150, 200), np.uint8)
    codes = lzw(index, defer=defer)
    assert max(w for _, w in codes) == 12
    got = same_as_cv2(tmp_path, gif((150, 200), [dict(index=index,
                                                      codes=codes)]))
    np.testing.assert_array_equal(got, PALETTE[index])


def test_malformed_lzw_data_equals_cv2(tmp_path):
    """End codes inside the data reset the table and the codes go on; a
    code past the table, a first code that is no literal, too few or too
    many pixels give None; one code after the image is full is ignored
    only when it is the last; no clear code first, or no end code, is
    fine."""
    index = RNG.integers(0, 16, (60, 80), np.uint8)
    codes = lzw(index)
    half = lzw(index[:30]), lzw(index[30:])
    bad_code, no_literal = list(codes), list(codes)
    bad_code[3] = (1000, bad_code[3][1])
    no_literal[1] = (258, 9)
    small = RNG.integers(0, 256, (10, 20), np.uint8)
    body = literal_codes(small)[:-1]
    tails = ([257, 0], [257, 0, 0, 0], [257, 5], [257, 256, 5], [5],
             [5, 257], [257, 257], [256, 257], [256], [257, 5, 5, 5, 5], [0])
    cases = [(80, 60, half[0] + half[1]),
             (80, 60, half[0] + [(c, half[0][-1][1]) for c, _ in half[1][1:]]),
             (80, 60, bad_code), (80, 60, no_literal), (80, 60, codes[1:]),
             (80, 60, codes[:-1]), (80, 59, codes), (80, 61, codes)]
    cases += [(20, 10, body + [(c, 9) for c in t]) for t in tails]
    got = []
    for w, h, c in cases:
        data = gif((h, w), [dict(index=np.zeros((h, w), np.uint8),
                                 codes=c)])
        got.append(same_as_cv2(tmp_path, data) is None)
    assert got == [False, True, True, True, False, False, True, True,
                   False, True, False, False, False, True, False, False,
                   False, True, False]


def test_file_structure_equals_cv2(tmp_path):
    """GIF87a; extensions before the image (comment, application, plain
    text, unknown); a Graphic Control Extension of another size; a later
    image outside the screen (not checked); the first one outside it, of
    no size, or on a screen of no size; a byte that starts no block; no
    trailer; bytes after it."""
    one = gif((20, 30), [dict(index=INDEX)])
    head = 13 + 768
    exts = (b"\x21\xfe\x05hello\x00" + b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
            b"\x00\x00\x00" + b"\x21\x01\x0c" + bytes(12) + b"\x02hi\x00"
            + b"\x21\x99\x03abc\x00")
    no_size = bytearray(one)
    no_size[head + 5:head + 7] = b"\0\0"
    no_screen = bytearray(one)
    no_screen[6:8] = b"\0\0"
    cases = [gif((20, 30), [dict(index=INDEX)], version=b"GIF87a"),
             one[:head] + exts + one[head:],
             gif((20, 30), [dict(index=INDEX),
                            dict(index=INDEX[:10, :10], at=(25, 15))]),
             one[:-1] + b"\x21\xf9\x04\x01\x00\x00\x03\x00\x3b",
             one + b"junk",
             one[:head] + b"\x21\xf9\x05\x01\x00\x00\x03\x00\x00"
             + one[head:],
             gif((20, 29), [dict(index=INDEX)]), bytes(no_size),
             bytes(no_screen), one[:-1] + b"\x00\x3b", one[:-1] + b"\x99",
             one[:-1]]
    got = [same_as_cv2(tmp_path, data) is None for data in cases]
    assert got == [False] * 5 + [True] * 7


@pytest.mark.parametrize("source", ["lzw", "interlaced", "cv2"])
def test_truncated_files_equal_cv2(tmp_path, source):
    """Every cut of a file gives None, as cv2 gives it (the block
    structure is walked to the trailer first)."""
    data = {"lzw": lambda: gif((20, 30), [dict(index=INDEX)]),
            "interlaced": lambda: gif((20, 30), [dict(index=INDEX,
                                                      interlace=True)]),
            "cv2": lambda: cv2.imencode(".gif", scene_image(37, 53))[1]
            .tobytes()}[source]()
    for n in range(0, len(data), 13):
        assert same_as_cv2(tmp_path, data[:n]) is None
    assert same_as_cv2(tmp_path, data[:-1]) is None


# ---------------------------------------------------------- numpy writer
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (19, 1), (37, 53),
                                (120, 160)])
def test_numpy_gif_writer_gives_the_palette_image_and_equals_cv2(tmp_path,
                                                                  hw):
    """testing/photos.py's GIF (literal LZW codes, a clear code before
    every 254) of a frame quantised to the fixed 3-3-2 palette decodes to
    palette[index], as cv2 reads it."""
    index, palette = photos.quantize_332(scene_image(*hw))
    got = same_as_cv2(tmp_path, photos.encode_gif(index, palette))
    np.testing.assert_array_equal(got, palette[index])


# ---------------------------------------------------------- slam_main
def test_slam_main_on_gif_photos_against_jax(tmp_path, no_native):
    """The hallway at 540x960, 14 frames as GIF (Pillow's: an adaptive
    palette of 256 colours, dithered, and real LZW codes): the port (its
    own reader) and the JAX package (cv2.imread) track the same frames,
    ATE within 0.02 of the extent."""
    from test_torch_video import _rel_ate

    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=7, baseline=0.25, kind="hallway")
    for i in range(14):
        (tmp_path / f"frame_{i:02d}.gif").write_bytes(pil_bytes(
            Image.fromarray(scene.render(i)).quantize(256), "GIF"))
    pattern = tmp_path / "frame_*.gif"
    for d in ("jax", "torch"):
        (tmp_path / d).mkdir()
    gd_j = japp.slam_main(_photo_cfg(jconfig, pattern, tmp_path / "jax"),
                          scene.K)
    gd_t = tapp.slam_main(_photo_cfg(tconfig, pattern, tmp_path / "torch"),
                          scene.K, device="cpu")
    assert [int(f) for f in gd_t.frame_ids] == \
        [int(f) for f in gd_j.frame_ids]
    assert len(gd_t.rotations) >= 10
    rel_t, rel_j = _rel_ate(scene, gd_t), _rel_ate(scene, gd_j)
    assert rel_t < 0.08 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)
