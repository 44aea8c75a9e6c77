"""The port's JPEG 2000 reader (io/jp2.py over native/jp2.cpp: OpenJPEG
2.5.3's decode, OpenCV 5.0's conversion to 8 bits) against ``cv2.imread``
of the same bytes written to a file, bit for bit, None included:

- every option of Pillow's writer (OpenJPEG 2.5.4), one or more at a
  time: 5/3 and 9/7, the five progression orders, tiles and their offsets,
  image offsets (None: OpenCV takes no offset), precincts, code-block
  sizes, resolutions, rate and dB layers, the colour transform on and off,
  a raw J2K codestream, PLT markers, signed samples (None), cinema
  profiles, comments; RGBA, grey with alpha, 16-bit grey; cv2's own writer
  at 8 and 16 bits;
- JP2 boxes written here around Pillow's codestreams: a palette (8 and
  16-bit entries), channel definitions that swap or leave a channel out,
  the colour spaces (sRGB, grey, sYCC through OpenCV's YUV conversion;
  CMYK and eYCC give None; an unknown space or an ICC profile is taken as
  sRGB), precisions over 8 bits and under 8 (None);
- cuts and single-bit flips against cv2 on one thread (OpenJPEG's strict
  mode, which OpenCV keeps: a codestream cut short gives None);
- POC and RGN marker segments written in by hand (after COD);
- the code-block styles and HTJ2K, refused by name; a Motion JPEG 2000
  file gives None, as in cv2;
- the committed fixtures in ``testing/photo_fixtures/`` against their
  sha256 in ``cv2_sha256_jp2.json``, and the 32 FHD headline frames in
  ``testing/photo_fixtures/headline_jp2/`` (5.8 MB) against theirs (what
  chip_smoke.py holds the card to; rewrite both with ``PYTHONPATH=.:tests
  python tests/test_torch_jp2.py --write-fixtures``);
- slam_main on 14 JP2 photos at 540x960 against the JAX package's."""

import hashlib
import io
import json
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io import jp2, photo
from slam_indoor_code_tpu_torch.io.media import MediaSource
from test_torch_photos import _photo_cfg, no_native, scene_image  # noqa: F401

torch.set_num_threads(1)

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "photo_fixtures")
DIGESTS = FIXTURES / "cv2_sha256_jp2.json"
HEADLINE = FIXTURES / "headline_jp2"
# the headline frames as Pillow writes them: 9/7, RPCL, 1024x1024 tiles,
# 256x256 precincts, three rate layers (the last 1/34 of the raw size:
# at 1/84, 2.45 MB in all, the card's CLI run tracked 18 of 32 frames),
# PLT markers
HEADLINE_OPTIONS = {"irreversible": True, "progression": "RPCL",
                    "tile_size": (1024, 1024), "precinct_size": (256, 256),
                    "quality_mode": "rates", "quality_layers": [136, 68, 34],
                    "plt": True}


def cv2_read(tmp_path, data: bytes, name: str = "x.jp2"):
    """``cv2.imread`` (colour) of ``data`` as RGB; None where it gives no
    image."""
    p = tmp_path / name
    p.write_bytes(data)
    img = cv2.imread(str(p))
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def same_as_cv2(tmp_path, data: bytes, name: str = "x.jp2"):
    want = cv2_read(tmp_path, data, name)
    got = photo.decode(data)
    assert (got is None) == (want is None), (got is None, want is None)
    if want is not None:
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    return got


def pil_jp2(arr, mode=None, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr, mode).save(b, "JPEG2000", **kw)
    return b.getvalue()


@pytest.fixture(scope="module")
def images():
    return {"small": scene_image(61, 83, seed=3),
            "mid": scene_image(130, 190, seed=4)}


# ------------------------------------------------------- Pillow's writer
OPTIONS = {
    "lossless": {},
    "irreversible": {"irreversible": True},
    "tiles": {"tile_size": (32, 48), "irreversible": True},
    "precincts-cblk": {"precinct_size": (64, 64),
                       "codeblock_size": (16, 32)},
    "resolutions-1": {"num_resolutions": 1},
    "resolutions-3-97": {"num_resolutions": 3, "irreversible": True},
    "rates": {"quality_mode": "rates", "quality_layers": [80, 40, 20],
              "irreversible": True},
    "dB": {"quality_mode": "dB", "quality_layers": [30, 40, 50]},
    "mct-off": {"mct": 0},
    "mct-off-97": {"mct": 0, "irreversible": True},
    "plt": {"plt": True, "progression": "PCRL"},
    "comment": {"comment": "a comment"},
    "offset": {"offset": (5, 3), "tile_size": (64, 64)},
    "tile-offset": {"offset": (9, 7), "tile_offset": (3, 5),
                    "tile_size": (48, 48)},
    "signed": {"signed": True},
}


@pytest.mark.parametrize("name", list(OPTIONS))
@pytest.mark.parametrize("size", ["small", "mid"])
def test_pillow_options_equal_cv2(tmp_path, images, name, size):
    same_as_cv2(tmp_path, pil_jp2(images[size], **OPTIONS[name]))


@pytest.mark.parametrize("progression", ["LRCP", "RLCP", "RPCL", "PCRL",
                                         "CPRL"])
@pytest.mark.parametrize("irreversible", [False, True])
def test_progression_orders_with_tiles_precincts_layers(
        tmp_path, images, progression, irreversible):
    """Each order over several tiles, precincts smaller than the
    resolutions, three layers and small code-blocks."""
    same_as_cv2(tmp_path, pil_jp2(
        images["mid"], progression=progression, irreversible=irreversible,
        tile_size=(96, 80), precinct_size=(32, 32),
        codeblock_size=(16, 16), quality_mode="rates",
        quality_layers=[60, 30, 12], num_resolutions=4))


def test_raw_codestream_alpha_grey_and_16_bit(tmp_path, images):
    """A raw J2K (RGB read; a one-component one gives None: OpenCV's sRGB
    conversion takes three), RGBA (alpha dropped), grey and grey with
    alpha, 16-bit grey (shifted right by 8)."""
    rgb = images["small"]
    rng = np.random.default_rng(1)
    g16 = (rgb[..., 0].astype(np.uint16) * 257
           + rng.integers(0, 257, rgb.shape[:2])).astype(np.uint16)
    for data, name in (
            (pil_jp2(rgb, no_jp2=True), "x.j2k"),
            (pil_jp2(rgb, no_jp2=True, irreversible=True), "x.j2c"),
            (pil_jp2(rgb[..., 0], no_jp2=True), "x.j2k"),
            (pil_jp2(np.dstack([rgb, rgb[..., 1]])), "x.jp2"),
            (pil_jp2(np.dstack([rgb, rgb[..., 1]]), irreversible=True),
             "x.jp2"),
            (pil_jp2(rgb[..., 0]), "x.jp2"),
            (pil_jp2(np.dstack([rgb[..., 0], rgb[..., 2]]), "LA"), "x.jp2"),
            (pil_jp2(g16), "x.jp2")):
        same_as_cv2(tmp_path, data, name)


def test_cinema_profile_equals_cv2(tmp_path):
    """Pillow's 2K cinema profile (its fixed 1080x2048 size, 9/7, CPRL)."""
    frame = cv2.resize(scene_image(270, 512, seed=5), (2048, 1080))
    same_as_cv2(tmp_path, pil_jp2(frame, cinema_mode="cinema2k-24"))


@pytest.mark.parametrize("rate", [None, 20, 200])
def test_cv2_writer_equals_cv2(tmp_path, images, rate):
    """cv2's own writer at 8 bits (its default, and at compression
    ratios) and at 16 bits."""
    bgr = np.ascontiguousarray(images["mid"][..., ::-1])
    params = [] if rate is None else [
        cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000 // rate]
    same_as_cv2(tmp_path, cv2.imencode(".jp2", bgr, params)[1].tobytes())
    b16 = bgr.astype(np.uint16) * 257 + 100
    same_as_cv2(tmp_path, cv2.imencode(".jp2", b16, params)[1].tobytes())


# ---------------------------------------------------------- JP2 boxes
def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def wrap(cs: bytes, enumcs: int = 16, extra: bytes = b"",
         colr: bytes | None = None) -> bytes:
    """A JP2 file around the codestream ``cs``: signature, ftyp, jp2h
    (ihdr, colr of ``enumcs`` or ``colr``, then ``extra``), jp2c."""
    w, h = struct.unpack(">II", cs[8:16])
    nc = struct.unpack(">H", cs[40:42])[0]
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, cs[42], 7, 0, 0))
    if colr is None:
        colr = box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", ihdr + colr + extra) + box(b"jp2c", cs))


def pclr(entries: np.ndarray, bits: int) -> bytes:
    n, k = entries.shape
    fmt = ">" + ("B" if bits <= 8 else "H") * k
    return box(b"pclr", struct.pack(">HB", n, k) + bytes([bits - 1] * k)
               + b"".join(struct.pack(fmt, *map(int, row))
                          for row in entries))


def cmap(*entries) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def cdef(*entries) -> bytes:
    return box(b"cdef", struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHH", *e) for e in entries))


def test_colour_spaces_palettes_and_channel_definitions(tmp_path, images):
    rgb = images["small"]
    rng = np.random.default_rng(2)
    cs = pil_jp2(rgb, no_jp2=True, mct=0)
    cs97 = pil_jp2(rgb, no_jp2=True, irreversible=True)
    grey = pil_jp2(rgb[..., 0], no_jp2=True)
    pal8 = rng.integers(0, 256, (256, 3))
    pal16 = rng.integers(0, 65536, (200, 3))
    mapped = cmap((0, 1, 0), (0, 1, 1), (0, 1, 2))
    for data in (
            wrap(cs), wrap(cs97), wrap(cs, 18), wrap(cs97, 18),
            wrap(grey, 18), wrap(cs, 17), wrap(grey, 17), wrap(cs, 12),
            wrap(cs, 24), wrap(cs, 99),
            wrap(cs, colr=box(b"colr", b"\x02\x00\x00" + bytes(40))),
            wrap(grey, 16, pclr(pal8, 8) + mapped),
            wrap(grey, 16, pclr(pal16, 16) + mapped),
            wrap(grey, 16, pclr(pal8, 8)),
            wrap(grey, 16, pclr(pal8, 8)
                 + cmap((0, 1, 2), (0, 1, 0), (0, 0, 0))),
            wrap(cs, 16, cdef((0, 0, 3), (1, 0, 2), (2, 0, 1))),
            wrap(cs, 16, cdef((0, 1, 0), (1, 1, 0))),
            wrap(cs, 16, cdef((0, 0, 1), (1, 0, 2), (2, 0, 3)))):
        same_as_cv2(tmp_path, data)


def test_precisions_over_and_under_8_bits(tmp_path, images):
    """12-bit grey in a JP2 (shifted right by 4), the precision of a 16-bit
    codestream written down to 12 (the DC shift and clamp at 12 bits), 7
    bits (None) and a subsampled component (None)."""
    rng = np.random.default_rng(3)
    h, w = images["small"].shape[:2]
    g12 = rng.integers(0, 4096, (h, w)).astype(np.uint16)
    cs12 = bytearray(pil_jp2(g12, no_jp2=True))
    cs12[42] = 11
    g16 = bytearray(pil_jp2((g12.astype(np.uint32) * 16).astype(np.uint16),
                            no_jp2=True))
    g16[42] = 11
    rgb = bytearray(pil_jp2(images["small"], no_jp2=True))
    seven, sub = bytearray(rgb), bytearray(rgb)
    seven[42] = 6
    sub[46] = 2
    for data in (wrap(bytes(cs12), 17), wrap(bytes(g16), 17),
                 wrap(bytes(seven)), wrap(bytes(sub))):
        same_as_cv2(tmp_path, data)


def _after_cod(cs: bytes, segment: bytes) -> bytes:
    at = cs.find(b"\xff\x52")
    at += 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]
    return cs[:at] + segment + cs[at:]


def poc(*entries) -> bytes:
    body = b"".join(struct.pack(">BBHBBB", *e) for e in entries)
    return b"\xff\x5f" + struct.pack(">H", 2 + len(body)) + body


@pytest.mark.parametrize("progression", ["LRCP", "RLCP", "RPCL", "PCRL",
                                         "CPRL"])
def test_poc_and_rgn_written_in_by_hand(tmp_path, images, progression):
    """A POC after COD (nothing here writes one) naming the stream's own
    order, another order, the resolutions split in two, the layers split
    across two orders, the components apart; an RGN max-shift of 0, 3 and
    8 on a component: each decoded as cv2 decodes it, whether the packets
    it names are the ones stored or not."""
    code = ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"].index(progression)
    cs = pil_jp2(images["small"], no_jp2=True, progression=progression,
                 quality_mode="rates", quality_layers=[40, 20, 10],
                 precinct_size=(32, 32), num_resolutions=4,
                 tile_size=(48, 40))
    for segment in (
            poc((0, 0, 3, 4, 3, code)), poc((0, 0, 3, 4, 3, (code + 1) % 5)),
            poc((0, 0, 3, 2, 3, code), (2, 0, 3, 4, 3, code)),
            poc((0, 0, 1, 4, 3, code), (0, 0, 3, 4, 3, (code + 2) % 5)),
            poc((0, 1, 3, 4, 3, code), (0, 0, 2, 4, 1, (code + 3) % 5)),
            *(b"\xff\x5e" + struct.pack(">HBBB", 5, 1, 0, shift)
              for shift in (0, 3, 8))):
        same_as_cv2(tmp_path, _after_cod(cs, segment), "x.j2k")


# ----------------------------------------------------------- refusals
@pytest.mark.parametrize("bit,name", [
    (1, "bypass"), (2, "reset"), (4, "termination on each"),
    (8, "vertically causal"), (16, "predictable termination"),
    (32, "segmentation symbols"), (64, "HTJ2K")])
def test_code_block_styles_are_refused_by_name(tmp_path, images, bit,
                                               name):
    """The COD's code-block style byte set by hand: cv2 reads each file
    (its decode of a stream not coded that way), but for the HT bit,
    where OpenJPEG's HT decoder fails on it; the port refuses it, naming
    the style."""
    data = bytearray(pil_jp2(images["small"], no_jp2=True))
    at = bytes(data).find(b"\xff\x52")
    data[at + 12] = bit
    assert (cv2_read(tmp_path, bytes(data), "x.j2k") is None) == (bit == 64)
    with pytest.raises(NotImplementedError, match=name):
        photo.decode(bytes(data))


def test_htj2k_is_refused_by_name(tmp_path, images):
    """Rsiz's Part 15 bit, and a CAP marker segment."""
    data = bytearray(pil_jp2(images["small"], no_jp2=True))
    data[6] |= 0x40
    with pytest.raises(NotImplementedError, match="HTJ2K"):
        photo.decode(bytes(data))
    plain = pil_jp2(images["small"], no_jp2=True)
    at = plain.find(b"\xff\x52")
    cap = b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00"
    with pytest.raises(NotImplementedError, match="HTJ2K"):
        photo.decode(plain[:at] + cap + plain[at:])


def test_motion_jpeg_2000_gives_none(tmp_path, images):
    """An MJ2 file (ftyp ``mjp2``, moov, mdat): cv2.imread gives none."""
    cs = pil_jp2(images["small"], no_jp2=True)
    data = (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"mjp2\0\0\0\0mjp2")
            + box(b"moov", bytes(20)) + box(b"mdat", cs))
    assert cv2_read(tmp_path, data, "x.mj2") is None
    assert photo.decode(data) is None


# ------------------------------------------------------------- damage
def damaged(data: bytes, seed: int, cuts: int = 40, flips: int = 80):
    rng = np.random.default_rng(seed)
    step = max(1, len(data) // cuts)
    out = [data[:n] for n in range(0, len(data), step)]
    out += [data[:-1], data[:-2], data[:-3], data[:-2] + b"\0\0",
            data + b"trailing"]
    for _ in range(flips):
        b = bytearray(data)
        i = int(rng.integers(12, len(b)))
        b[i] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("kind", ["97-layers-tiles", "53", "cv2"])
def test_cut_and_flipped_files_equal_cv2_on_one_thread(tmp_path, images,
                                                       kind):
    rgb = images["small"]
    data = {"97-layers-tiles": lambda: pil_jp2(
        rgb, irreversible=True, quality_mode="rates",
        quality_layers=[60, 30, 10], tile_size=(32, 32)),
        "53": lambda: pil_jp2(rgb, progression="RPCL",
                              precinct_size=(32, 32)),
        "cv2": lambda: cv2.imencode(".jp2", rgb[..., ::-1].copy())[
            1].tobytes()}[kind]()
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        results = [same_as_cv2(tmp_path, d)
                   for d in damaged(data, seed=len(kind))]
    finally:
        cv2.setNumThreads(threads)
    assert any(r is None for r in results)
    assert any(r is not None for r in results)


def test_components_report_openjpegs_image(images):
    """io/jp2.components: the colour space and each component's geometry
    as OpenJPEG gives them."""
    space, comps = jp2.components(pil_jp2(images["small"], offset=(5, 3),
                                          tile_size=(32, 32)))
    assert space == 1 and len(comps) == 3
    assert (comps[0]["x0"], comps[0]["y0"], comps[0]["prec"]) == (5, 3, 8)
    assert comps[0]["data"].shape == images["small"].shape[:2]


# ------------------------------------------------------------ fixtures
def fixture_files() -> dict:
    """name -> bytes of the small committed JPEG 2000 fixtures."""
    rgb = scene_image(61, 83, seed=11)
    rng = np.random.default_rng(12)
    cs = pil_jp2(rgb, no_jp2=True, mct=0)
    out = {f"jp2_{p.lower()}_{'97' if i % 2 else '53'}.jp2": pil_jp2(
        rgb, progression=p, irreversible=bool(i % 2), tile_size=(48, 32),
        precinct_size=(32, 32), codeblock_size=(16, 16),
        quality_mode="rates", quality_layers=[40, 20, 8])
        for i, p in enumerate(("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"))}
    out.update({
        "jp2_raw_97.j2k": pil_jp2(rgb, no_jp2=True, irreversible=True),
        "jp2_offset_none.jp2": pil_jp2(rgb, offset=(5, 3),
                                       tile_size=(48, 48)),
        "jp2_palette.jp2": wrap(pil_jp2(rgb[..., 1], no_jp2=True), 16,
                                pclr(rng.integers(0, 256, (256, 3)), 8)
                                + cmap((0, 1, 0), (0, 1, 1), (0, 1, 2))),
        "jp2_grey.jp2": pil_jp2(rgb[..., 0], irreversible=True),
        "jp2_grey16.jp2": pil_jp2((rgb[..., 0].astype(np.uint16) * 257
                                   + 99).astype(np.uint16)),
        "jp2_sycc.jp2": wrap(cs, 18),
        "jp2_cv2_16bit.jp2": cv2.imencode(".jp2", (rgb[..., ::-1].astype(
            np.uint16) * 250))[1].tobytes(),
    })
    return out


def headline_frames() -> list:
    """The 32 FHD hallway frames chip_smoke.py renders (seed 7)."""
    from slam_indoor_code_tpu_torch.testing import make_scene as scene_of

    sc = scene_of(n_points=1500, n_frames=32, image_size=(1080, 1920),
                  seed=7, baseline=0.25, kind="hallway")
    return [sc.render(i) for i in range(32)]


def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write_fixtures() -> None:
    """The small fixtures with cv2's sha256 of each (None where cv2 gives
    no image) beside the other photo fixtures'; the headline frames as
    Pillow writes them (HEADLINE_OPTIONS) with their table."""
    table = {}
    for name, data in fixture_files().items():
        path = FIXTURES / name
        path.write_bytes(data)
        img = cv2.imread(str(path))
        table[name] = None if img is None else {
            "shape": list(img.shape), "sha256": _sha(img[..., ::-1])}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")
    HEADLINE.mkdir(exist_ok=True)
    table = {}
    for i, frame in enumerate(headline_frames()):
        path = HEADLINE / f"frame_{i:02d}.jp2"
        path.write_bytes(pil_jp2(frame, **HEADLINE_OPTIONS))
        table[path.name] = _sha(cv2.imread(str(path))[..., ::-1])
    (HEADLINE / "cv2_sha256.json").write_text(json.dumps(table, indent=1)
                                              + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256(no_native):
    table = json.loads(DIGESTS.read_text())
    assert sorted(table) == sorted(fixture_files())
    assert sum(table[k] is None for k in table) == 1
    for name, want in table.items():
        path = FIXTURES / name
        img = cv2.imread(str(path))
        got = list(MediaSource(photos_pattern=str(path)))
        if want is None:
            assert img is None and got == [], name
            continue
        assert _sha(img[..., ::-1]) == want["sha256"], name
        assert len(got) == 1 and list(got[0].shape) == want["shape"], name
        assert _sha(got[0]) == want["sha256"], name


def test_headline_fixtures_equal_cv2_and_fit_their_size():
    """The 32 FHD frames: 6 MB or less in all, Pillow's options (RPCL,
    9/7, PLT in the codestream), and each decodes to cv2's recorded
    sha256 in the port and in cv2 here."""
    table = json.loads((HEADLINE / "cv2_sha256.json").read_text())
    paths = sorted(HEADLINE.glob("frame_*.jp2"))
    assert [p.name for p in paths] == sorted(table) and len(paths) == 32
    assert sum(p.stat().st_size for p in paths) <= 6_000_000
    for p in paths:
        data = p.read_bytes()
        assert b"\xff\x58" in data and data[:12] == jp2.MAGICS[1]
        assert _sha(cv2.imread(str(p))[..., ::-1]) == table[p.name]
        assert _sha(jp2.decode(data)) == table[p.name], p.name


# -------------------------------------------------------------- slam_main
def test_slam_main_on_jp2_photos_against_jax(tmp_path, no_native):
    """The hallway at 540x960, 14 frames as JP2 (Pillow's 9/7 at rate 20
    and 5/3, cv2's writer, cycled): the port (io/jp2.py) and the JAX
    package (cv2.imread) read the same frames and track the same ones,
    ATE within 0.02 of the extent."""
    from test_torch_video import _rel_ate

    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=7, baseline=0.25, kind="hallway")
    writers = (lambda f: pil_jp2(f, irreversible=True, quality_mode="rates",
                                 quality_layers=[20], progression="RPCL"),
               lambda f: pil_jp2(f, tile_size=(512, 512)),
               lambda f: cv2.imencode(".jp2", f[..., ::-1].copy())[
                   1].tobytes())
    for i in range(14):
        (tmp_path / f"frame_{i:02d}.jp2").write_bytes(
            writers[i % len(writers)](scene.render(i)))
    pattern = tmp_path / "frame_*.jp2"
    want = list(JMediaSource(photos_pattern=str(pattern), threads=3))
    got = list(MediaSource(photos_pattern=str(pattern), threads=3))
    assert len(got) == len(want) == 14
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for d in ("jax", "torch"):
        (tmp_path / d).mkdir()
    gd_j = japp.slam_main(_photo_cfg(jconfig, pattern, tmp_path / "jax"),
                          scene.K)
    gd_t = tapp.slam_main(_photo_cfg(tconfig, pattern, tmp_path / "torch"),
                          scene.K, device="cpu")
    assert [int(f) for f in gd_t.frame_ids] == \
        [int(f) for f in gd_j.frame_ids]
    assert len(gd_t.rotations) == len(gd_j.rotations) >= 10
    rel_t, rel_j = _rel_ate(scene, gd_t), _rel_ate(scene, gd_j)
    assert rel_t < 0.08 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
