"""The port's photo media (io/media.py, io/native.py, io/png.py) on the CPU:
natural sort and MediaSource against the JAX package's, bit for bit, on
PNG and JPEG files written by cv2; the port's own PNG reader (the decoder
where libpng cannot be built) over every colour type and row filter; the
native build's failure; the video the port refuses (io/avi.py; the MJPEG
reader itself is in tests/test_torch_video.py, the MPEG-4 one in
tests/test_torch_mp4.py); MPEG program and transport streams, named by
their container and read (tests/test_torch_mpeg2.py holds them in full);
uncompressed I420/IYUV/Y800 AVIs against cv2, odd heights (swscale's
scaling path) against cv2 and sws_scale; and the gray plane the
frames become, against the JAX package's."""

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
    """A 16-bit PNG, once refused, now decodes to cv2's pixels (each
    sample's high byte; tests/test_torch_photos.py covers every depth and
    colour type); a file that is not a PNG is still refused."""
    p = tmp_path / "deep.png"
    deep = np.random.default_rng(0).integers(0, 65536, (4, 5, 3))
    cv2.imwrite(str(p), deep.astype(np.uint16))
    np.testing.assert_array_equal(png.read_png(str(p)),
                                  cv2.imread(str(p))[:, :, ::-1])
    (tmp_path / "no.png").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "no.png"))


# ------------------------------------------------------ without native
def test_pooled_reader_without_native(scene_frames, tmp_path, no_native):
    """Without the native decoder: the thread-pool PNG reader gives the
    same frames in natural order and skips an undecodable file; a JPEG
    goes to the port's own decoder (io/jpeg.py), to cv2's pixels."""
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
    np.testing.assert_array_equal(media._imread_rgb(str(tmp_path / "x.jpg")),
                                  cv2.imread(str(tmp_path / "x.jpg"))[..., ::-1])


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
def _avi_with_fourcc(path, fourcc: bytes):
    from slam_indoor_code_tpu_torch.testing import mjpeg

    mjpeg.write_avi(str(path), [mjpeg.encode_jpeg(np.zeros((8, 8, 3),
                                                           np.uint8))], 8, 8)
    data = path.read_bytes()
    i = data.index(b"strf") + 8 + 16           # BITMAPINFOHEADER.biCompression
    path.write_bytes(data[:i] + fourcc + data[i + 4:])


@pytest.mark.parametrize("case,error,match", [
    ("missing", IOError, "Video wasn't opened: "),
    ("not_a_video", IOError, "Video wasn't opened: "),
    ("h264_avi", NotImplementedError, "video codec 'H264' needs a decoder"),
    ("div3_avi", NotImplementedError, "video codec 'DIV3' needs a decoder"),
    ("mp4_without_moov", IOError, "Video wasn't opened: "),
    ("mkv", NotImplementedError, "Matroska/WebM"),
    ("mkv_without_elements", IOError, "Video wasn't opened: "),
])
def test_video_media_is_not_ported(tmp_path, case, error, match):
    """The video the port does not read: a file that does not open (an MP4
    without its moov box, or an EBML magic and nothing after it, too)
    raises the JAX package's ``IOError``; a codec other than Motion-JPEG,
    MPEG-4 Part 2, VP8 and VP9 (here AV1 in a Matroska track),
    ``NotImplementedError`` naming it (MP4's other codecs:
    tests/test_torch_mp4.py; Matroska's: tests/test_torch_webm.py)."""
    path = tmp_path / "seq.avi"
    if case == "not_a_video":
        path.write_bytes(b"plain text, no RIFF header here")
    elif case.endswith("_avi"):
        _avi_with_fourcc(path, case[:4].upper().encode())
    elif case == "mp4_without_moov":
        path = tmp_path / "seq.mp4"
        path.write_bytes(b"\0\0\0\x18ftypmp42" + bytes(32))
    elif case == "mkv":
        def el(eid: bytes, body: bytes) -> bytes:
            return eid + bytes([0x80 | len(body)]) + body
        entry = (el(b"\xd7", b"\x01") + el(b"\x83", b"\x01")
                 + el(b"\x86", b"V_AV1"))
        path = tmp_path / "seq.mkv"
        path.write_bytes(el(b"\x1a\x45\xdf\xa3", el(b"\x42\x82", b"webm"))
                         + el(b"\x18\x53\x80\x67",
                              el(b"\x16\x54\xae\x6b", el(b"\xae", entry))))
    elif case == "mkv_without_elements":
        path = tmp_path / "seq.mkv"
        path.write_bytes(b"\x1a\x45\xdf\xa3" + bytes(32))
    with pytest.raises(error, match=match):
        MediaSource(video_path=str(path), use_photos=False)


@pytest.mark.parametrize("fourcc,ext", [("MPEG", "mpg"), ("mpg2", "mpg"),
                                        ("MPEG", "ts"), ("mpg2", "ts")])
def test_mpeg_program_and_transport_streams_are_named(tmp_path, scene_frames,
                                                     fourcc, ext):
    """cv2's MPEG-1/2 writers into an MPEG program stream (.mpg) and a
    transport stream (.ts), which cv2 reads back: ``avi.mpeg_container``
    names the container, and the port reads its frames equal to cv2's
    (tests/test_torch_mpeg2.py holds the demuxers and the decoder in
    full)."""
    path = tmp_path / f"seq.{ext}"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10.0,
                         (128, 96))
    for f in scene_frames[:4]:
        vw.write(cv2.resize(f, (128, 96)))
    vw.release()
    from slam_indoor_code_tpu_torch.io import avi

    want = _cv2_frames(path)
    assert len(want) == 4
    name = ("MPEG program stream" if ext == "mpg"
            else "MPEG transport stream")
    assert avi.mpeg_container(path.read_bytes()[:2048]) == name
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(np.ascontiguousarray(f[..., ::-1]))


@pytest.mark.parametrize("fourcc", ["I420", "IYUV", "Y800", "zero"])
@pytest.mark.parametrize("hw", [(96, 128), (36, 54), (480, 640)])
def test_uncompressed_avi_equals_cv2(tmp_path, scene_frames, fourcc, hw):
    """cv2's uncompressed writers (fourcc 0 is stored as I420; Y800 frames
    are I420-sized, read as gray with 4-byte aligned rows where they fit,
    as FFmpeg reads them): every frame equals cv2's bit for bit."""
    path = tmp_path / "raw.avi"
    code = 0 if fourcc == "zero" else cv2.VideoWriter_fourcc(*fourcc)
    vw = cv2.VideoWriter(str(path), code, 10.0, hw[::-1])
    for f in scene_frames[:5]:
        vw.write(cv2.cvtColor(cv2.resize(f, hw[::-1]), cv2.COLOR_RGB2BGR))
    vw.release()
    want = _cv2_frames(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           threads=3))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _i420_avi(path, planes, w, h, fourcc=b"I420"):
    from slam_indoor_code_tpu_torch.testing import mjpeg

    mjpeg.write_avi(str(path), [b"".join(p.tobytes() for p in frame)
                                for frame in planes], w, h, fourcc=fourcc)


def _planes(rng, h, w):
    c = ((h + 1) // 2, (w + 1) // 2)
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, c, np.uint8),
            rng.integers(0, 256, c, np.uint8))


@pytest.mark.parametrize("hw", [(37, 54), (95, 160), (201, 36), (37, 53),
                                (1079, 1920)])
def test_odd_height_i420_equals_cv2_and_swscale(tmp_path, hw):
    """Hand-written I420 AVIs at odd heights (cv2's writer rounds sizes to
    even): swscale's scaling path (bicubic chroma; full horizontal chroma
    at an odd width), bit for bit cv2's frames and sws_scale's on the same
    planes."""
    from test_torch_mp4 import swscale_rgb

    rng = np.random.default_rng(hw[0] + hw[1])
    planes = [_planes(rng, *hw) for _ in range(2)]
    path = tmp_path / "odd.avi"
    _i420_avi(path, planes, hw[1], hw[0])
    want = _cv2_frames(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 2
    for a, b, p in zip(got, want, planes):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, swscale_rgb(*p))


def test_short_uncompressed_chunk_ends_the_video_as_cv2_does(tmp_path):
    """An I420 chunk shorter than a frame: FFmpeg's rawvideo decoder
    refuses it and cv2 stops there; so does the port."""
    rng = np.random.default_rng(9)
    planes = [_planes(rng, 48, 64) for _ in range(5)]
    frames = [b"".join(p.tobytes() for p in f) for f in planes]
    frames[2] = frames[2][:1000]
    from slam_indoor_code_tpu_torch.testing import mjpeg

    path = tmp_path / "short.avi"
    mjpeg.write_avi(str(path), frames, 64, 48, fourcc=b"I420")
    want = _cv2_frames(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fourcc", ["YUY2", "UYVY"])
def test_packed_yuv_avi_is_refused_naming_the_fourcc(tmp_path, scene_frames,
                                                     fourcc):
    """cv2's YUY2 and UYVY writers make AVIs cv2 itself reads no frame of:
    the port refuses them, naming the fourcc."""
    path = tmp_path / "packed.avi"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10.0,
                         (64, 48))
    for f in scene_frames[:2]:
        vw.write(cv2.resize(f, (64, 48)))
    vw.release()
    assert _cv2_frames(path) == []
    with pytest.raises(NotImplementedError, match=fourcc):
        MediaSource(video_path=str(path), use_photos=False)


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


def test_rgb_to_gray_equals_jax_eager_on_an_fhd_frame():
    """The port's gray plane is the JAX package's eager ``rgb_to_gray`` bit
    for bit at FHD (the same three products and two sums in float32).  The
    jitted JAX form can differ on some pixels: XLA contracts a product and
    a sum into one fused multiply-add there."""
    import jax.numpy as jnp
    import torch

    from slam_indoor_code_tpu.ops import image as jimage
    from slam_indoor_code_tpu.testing import make_scene as jmake_scene
    from slam_indoor_code_tpu_torch.ops import image as timage

    frame = jmake_scene(n_points=1500, n_frames=1, seed=7, baseline=0.3,
                        image_size=(1080, 1920)).render(0)
    want = np.asarray(jimage.rgb_to_gray(jnp.asarray(frame)))
    got = timage.rgb_to_gray(torch.from_numpy(frame)).numpy()
    assert got.shape == (1080, 1920) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
