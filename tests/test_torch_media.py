"""The port's photo media (io/media.py, io/native.py, io/png.py) on the CPU:
natural sort and MediaSource against the JAX package's, bit for bit, on
PNG and JPEG files written by cv2; the port's own PNG reader (the decoder
where libpng cannot be built) over every colour type and row filter; the
native build's failure; and what stays unported (video)."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu.io.media import natural_sort_paths as j_sort
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io import media, native, png
from slam_indoor_code_tpu_torch.io.media import ArraySource, MediaSource


@pytest.fixture(scope="module")
def scene_frames():
    sc = make_scene(n_points=300, n_frames=12, seed=5, baseline=0.3)
    return [sc.render(i) for i in range(12)]


@pytest.fixture
def no_native(monkeypatch):
    """As on a machine where the native decoder does not build."""
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "g++: jpeglib.h: No such file")


@pytest.mark.parametrize("names", [
    ["img10.jpg", "img2.jpg", "img1.jpg", "a/img3.jpg"],
    ["frame_010.png", "frame_002.png", "frame_1.png", "frame_0100.png"],
    ["z.png", "aa.png", "b.png", "ab.png", "a.png"],
])
def test_natural_sort_paths_equals_jax(names):
    assert media.natural_sort_paths(names) == j_sort(names)


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_media_source_equals_jax(scene_frames, tmp_path, ext):
    """cv2-written files (named so that natural and plain sorting differ)
    through both packages' MediaSource: the same frames bit for bit."""
    for i, f in enumerate(scene_frames):
        cv2.imwrite(str(tmp_path / f"f{i}.{ext}"),
                    cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    pattern = str(tmp_path / f"*.{ext}")
    want = list(JMediaSource(photos_pattern=pattern, threads=3))
    got = list(MediaSource(photos_pattern=pattern, threads=3))
    assert len(got) == len(want) == len(scene_frames)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if ext == "png":                     # lossless: the rendered frames
        for a, b in zip(got, scene_frames):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ PNG reader
def _filter_row(kind, row, prior, bpp):
    """PNG row filter ``kind`` of ``row`` given the unfiltered ``prior``."""
    r = row.astype(np.int64)
    p = prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) // 2
    else:
        pa, pb, pc = np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) % 256).astype(np.uint8)


def _write_png(path, img, ctype, kinds):
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    bpp = rows.shape[1] // w
    prior = np.zeros(rows.shape[1], np.uint8)
    raw = b""
    for y in range(h):
        k = kinds[y % len(kinds)]
        raw += bytes([k]) + _filter_row(k, rows[y], prior, bpp).tobytes()
        prior = rows[y]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    # two IDAT chunks: the reader must join them
    z = zlib.compress(raw)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0))
                + chunk(b"IDAT", z[:len(z) // 2])
                + chunk(b"IDAT", z[len(z) // 2:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
def test_png_reader_every_colour_type_and_filter(tmp_path, ctype, channels,
                                                 kinds):
    rng = np.random.default_rng(ctype * 10 + len(kinds) + kinds[0])
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    img[4:9, 3:11] = img[4, 3]           # flat patches, as photos have
    _write_png(tmp_path / "x.png", img, ctype, kinds)
    got = png.read_png(str(tmp_path / "x.png"))
    want = np.repeat(img[..., :1], 3, -1) if channels <= 2 else img[..., :3]
    np.testing.assert_array_equal(got, want)


def test_png_reader_equals_cv2_on_its_files(scene_frames, tmp_path):
    for i, f in enumerate(scene_frames[:3]):
        p = str(tmp_path / f"{i}.png")
        cv2.imwrite(p, cv2.cvtColor(f, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])
        np.testing.assert_array_equal(png.read_png(p),
                                      cv2.imread(p)[:, :, ::-1])


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    p = tmp_path / "deep.png"
    cv2.imwrite(str(p), np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(str(p))
    (tmp_path / "no.png").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "no.png"))


# ------------------------------------------------------ without native
def test_pooled_reader_without_native(scene_frames, tmp_path, no_native):
    """Without the native decoder: the thread-pool PNG reader gives the
    same frames in natural order and skips an undecodable file; a JPEG
    raises and names libjpeg."""
    for i, f in enumerate(scene_frames):
        cv2.imwrite(str(tmp_path / f"f{i}.png"),
                    cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    (tmp_path / "f5.png").write_bytes(png.SIGNATURE + b"broken")
    src = MediaSource(photos_pattern=str(tmp_path / "*.png"), threads=2,
                      prefetch=3)
    assert not native.available()
    got = list(src)
    want = [f for i, f in enumerate(scene_frames) if i != 5]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert src.next_frame() is None
    cv2.imwrite(str(tmp_path / "x.jpg"), scene_frames[0])
    with pytest.raises(RuntimeError, match="libjpeg") as e:
        media._imread_rgb(str(tmp_path / "x.jpg"))
    assert "jpeglib.h" in str(e.value)


def test_native_build_failure_raises_with_the_compilers_message(
        tmp_path, monkeypatch):
    bad = tmp_path / "slamio.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "_build" / "lib.so")
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", None)
    with pytest.raises(RuntimeError, match="no_such_header_here"):
        native.load()
    assert not native.available()
    assert "no_such_header_here" in native.build_error()


# -------------------------------------------------------------- app glue
def test_video_media_is_not_ported():
    with pytest.raises(NotImplementedError, match="video decoder"):
        MediaSource(video_path="seq.avi", use_photos=False)


def test_make_media_builds_a_photo_source(scene_frames, tmp_path):
    for i, f in enumerate(scene_frames[:4]):
        cv2.imwrite(str(tmp_path / f"p{i}.png"),
                    cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    cfg = tconfig.Config(usePhotosCycle=True, threadsCount=2,
                         photosPathPattern=str(tmp_path / "*.png"),
                         outputDataDir=str(tmp_path))
    src = tapp.make_media(cfg)
    assert isinstance(src, MediaSource)
    np.testing.assert_array_equal(src.next_frame(), scene_frames[0])
    assert isinstance(tapp.make_media(cfg, frames=scene_frames), ArraySource)
    assert tapp.make_media(cfg, frames=src) is src
