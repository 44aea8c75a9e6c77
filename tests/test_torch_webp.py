"""The port's lossless and animated WebP reading (io/webp.py over
native/vp8l.cpp, and native/vp8.cpp for lossy frames) against
``cv2.imread`` bit for bit on the CPU: cv2's lossless writer at odd sizes
down to 1x1; Pillow's at methods 0, 4 and 6 and with ``exact``; palettes
of 2, 4, 16 and 256 colours (indices bundled 8, 4, 2 and 1 to a pixel);
smooth images that libwebp codes with the predictor and cross-colour
transforms and meta prefix codes; alpha; the ``VP8X`` layout with EXIF
orientations 1-8; the first frame of animated files (lossy and lossless,
at an offset, with alpha, each blending method); the RIFF size rules;
truncated and bit-flipped streams, which give what cv2 gives, None
included; the numpy writers of testing/photos.py; and slam_main on a
14-photo glob of lossless WebP against the JAX package's."""

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
from slam_indoor_code_tpu_torch.io import photo
from slam_indoor_code_tpu_torch.testing import photos
from test_torch_photos import (_photo_cfg, cv2_read, no_native,  # noqa: F401
                               pil_bytes, same_as_cv2, scene_image)

torch.set_num_threads(1)

SIZES = ((1, 1), (2, 3), (17, 16), (19, 1), (1, 17), (37, 53), (61, 77))


def smooth_image(h, w, seed=1):
    """Blurred noise with its channels mixed, and a little grain: libwebp
    codes it with the predictor and cross-colour transforms and, at a few
    hundred pixels a side, meta prefix codes."""
    rng = np.random.default_rng(seed)
    f = cv2.GaussianBlur(rng.normal(0, 1, (h, w, 3)), (0, 0), 6)
    g = f @ np.array([[1, .6, .3], [.2, 1, .5], [.4, .3, 1]]).T
    g = 255 * (g - g.min()) / (g.max() - g.min())
    return (g + rng.normal(0, 2, g.shape)).clip(0, 255).astype(np.uint8)


def cv2_lossless(rgb) -> bytes:
    return cv2.imencode(".webp", np.ascontiguousarray(rgb[..., ::-1]),
                        [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()


def image(hw, kind):
    if kind == "scene":
        return scene_image(*hw)
    if kind == "smooth":
        return smooth_image(*hw)
    return np.random.default_rng(hw[0] * 31 + hw[1]).integers(
        0, 256, hw + (3,), np.uint8)


def chunk(kind: bytes, data: bytes) -> bytes:
    return (kind + struct.pack("<I", len(data)) + data
            + b"\0" * (len(data) & 1))


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"WEBP" + body


def u24(v: int) -> bytes:
    return int(v).to_bytes(3, "little")


def animation(canvas, frames, bg=(10, 20, 30, 40)) -> bytes:
    """An animated WebP of the canvas (h, w) whose frames are (x, y, ANMF
    flags, the image chunks of a still WebP, the (h, w) ANMF states)."""
    body = chunk(b"VP8X", bytes([0x12, 0, 0, 0]) + u24(canvas[1] - 1)
                 + u24(canvas[0] - 1))
    body += chunk(b"ANIM", bytes([bg[2], bg[1], bg[0], bg[3], 0, 0]))
    for x, y, flags, payload, size in frames:
        body += chunk(b"ANMF", u24(x // 2) + u24(y // 2) + u24(size[1] - 1)
                      + u24(size[0] - 1) + u24(100) + bytes([flags])
                      + payload)
    return riff(body)


def still_chunks(data: bytes) -> bytes:
    """A still WebP's image chunks (ALPH and VP8, or VP8L), its VP8X
    dropped."""
    body = data[12:]
    return body[18:] if body[:4] == b"VP8X" else body


# ------------------------------------------------------------- lossless
@pytest.mark.parametrize("kind", ["scene", "noise", "smooth"])
@pytest.mark.parametrize("hw", SIZES)
def test_cv2_lossless_equals_cv2_and_the_source(tmp_path, hw, kind):
    """cv2's lossless writer (quality 101) at odd and even sizes down to
    one pixel: the photo itself, as cv2 reads it."""
    rgb = image(hw, kind)
    data = cv2_lossless(rgb)
    assert data[12:16] == b"VP8L"
    np.testing.assert_array_equal(same_as_cv2(tmp_path, data), rgb)


@pytest.mark.parametrize("kind", ["scene", "smooth"])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_pillow_lossless_methods_equal_cv2(tmp_path, method, kind):
    """Pillow (libwebp's encoder) at methods 0, 4 and 6, quality 0 and
    100: subtract-green, predictor, cross-colour, colour cache and meta
    prefix codes as libwebp picks them."""
    rgb = image((90, 160), kind)
    for quality in (0, 100):
        data = pil_bytes(Image.fromarray(rgb), "WEBP", lossless=True,
                         method=method, quality=quality)
        np.testing.assert_array_equal(same_as_cv2(tmp_path, data), rgb)


def test_larger_images_with_meta_prefix_codes_equal_cv2(tmp_path):
    """At 270x480 libwebp splits the smooth image's prefix codes into
    groups picked by an entropy image."""
    rgb = smooth_image(270, 480)
    for data in (cv2_lossless(rgb),
                 pil_bytes(Image.fromarray(rgb), "WEBP", lossless=True,
                           method=6, quality=100)):
        np.testing.assert_array_equal(same_as_cv2(tmp_path, data), rgb)


@pytest.mark.parametrize("exact", [False, True])
def test_alpha_is_dropped_as_cv2_drops_it(tmp_path, exact):
    """RGBA with transparent rows: with ``exact`` the RGB under alpha 0 is
    kept (and read), without it libwebp's encoder flattens it."""
    rgb = image((37, 53), "scene")
    a = np.random.default_rng(2).integers(0, 256, rgb.shape[:2], np.uint8)
    a[:6] = 0
    data = pil_bytes(Image.fromarray(np.dstack([rgb, a])), "WEBP",
                     lossless=True, exact=exact)
    got = same_as_cv2(tmp_path, data)
    np.testing.assert_array_equal(got[a > 0], rgb[a > 0])
    if exact:
        np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (37, 53)])
def test_palettes_with_bundled_indices_equal_cv2(tmp_path, colours, hw):
    """Colour indexing: 2 colours bundle 8 indices to a pixel, 4 colours
    4, 16 colours 2, 256 one; widths that leave a part-filled pixel."""
    q = Image.fromarray(image(hw, "scene")).quantize(colours)
    data = pil_bytes(q, "WEBP", lossless=True)
    np.testing.assert_array_equal(same_as_cv2(tmp_path, data),
                                  np.asarray(q.convert("RGB")))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_extended_lossless_with_exif_orientation_equals_cv2(tmp_path,
                                                            orientation):
    """VP8X + ICCP + VP8L + EXIF (Pillow), opaque and with alpha: cv2 turns
    the photo by the orientation."""
    rgb = image((37, 53), "scene")
    ex = Image.Exif()
    ex[0x0112] = orientation
    for im in (Image.fromarray(rgb),
               Image.fromarray(np.dstack([rgb, rgb[..., 1]]))):
        data = pil_bytes(im, "WEBP", lossless=True, exif=ex.tobytes(),
                         icc_profile=b"icc" * 41)
        assert data[12:16] == b"VP8X"
        same_as_cv2(tmp_path, data)


def test_extended_still_whose_canvas_differs_gives_none(tmp_path):
    data = bytearray(pil_bytes(Image.fromarray(image((37, 53), "scene")),
                               "WEBP", lossless=True, icc_profile=b"abc"))
    data[24] ^= 1                        # the VP8X canvas width
    assert cv2_read(tmp_path, bytes(data)) is None
    assert photo.decode(bytes(data)) is None


# ------------------------------------------------------------- animated
@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("frames", [1, 3])
def test_pillow_animations_give_cv2s_first_frame(tmp_path, lossless, frames):
    """Pillow's animated WebP (libwebp's WebPAnimEncoder), the first frame
    with a transparent border: lossy frames are cut to an offset
    rectangle; the canvas outside it is black, as cv2 gives it."""
    rgb = image((61, 77), "scene")
    a = np.full(rgb.shape[:2], 255, np.uint8)
    a[:10], a[:, :12] = 0, 0
    ims = [Image.fromarray(np.dstack([rgb, a]))] + [
        Image.fromarray(np.roll(rgb, 3 * i, 1)) for i in range(1, frames)]
    kw = {"lossless": True} if lossless else {"quality": 70}
    data = pil_bytes(ims[0], "WEBP", save_all=True, append_images=ims[1:],
                     background=(200, 100, 50, 255), **kw)
    got = same_as_cv2(tmp_path, data)
    if lossless:
        np.testing.assert_array_equal(got[a > 0], rgb[a > 0])


@pytest.mark.parametrize("flags", range(4))
@pytest.mark.parametrize("kind", ["lossless", "lossless_alpha", "lossy",
                                  "lossy_alpha"])
def test_first_frame_at_an_offset_equals_cv2(tmp_path, kind, flags):
    """A frame at (4, 6) on a 50x60 canvas, each blending and disposal
    flag: the canvas is zeros (not ANIM's background colour) and the
    frame's RGB is kept under any alpha, transparent pixels included."""
    rgb = image((37, 53), "scene")
    a = np.random.default_rng(3).integers(0, 256, rgb.shape[:2], np.uint8)
    a[:5] = 0
    im = (Image.fromarray(np.dstack([rgb, a])) if "alpha" in kind
          else Image.fromarray(rgb))
    kw = ({"lossless": True, "exact": True} if kind.startswith("lossless")
          else {"quality": 80})
    payload = still_chunks(pil_bytes(im, "WEBP", **kw))
    second = still_chunks(cv2_lossless(rgb[::-1]))
    data = animation((50, 60), [(4, 6, flags, payload, (37, 53)),
                                (0, 0, 0, second, (37, 53))])
    got = same_as_cv2(tmp_path, data)
    want = np.zeros((50, 60, 3), np.uint8)
    if kind.startswith("lossless"):
        want[6:43, 4:57] = rgb
        np.testing.assert_array_equal(got, want)
    else:
        assert not got[:6].any() and not got[:, :4].any()


def test_animation_edge_cases_equal_cv2(tmp_path):
    """The frame's size is its bitstream's, whatever ANMF states; a frame
    past the canvas, and an animation without frames, give None; one
    frame alone reads; so does an animation cut at no point."""
    rgb = image((37, 53), "scene")
    ll = still_chunks(cv2_lossless(rgb))
    lossy = still_chunks(cv2.imencode(".webp", rgb[..., ::-1], [
        cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes())
    cases = [animation((50, 60), [(2, 2, 0, ll, (30, 41))]),
             animation((50, 60), [(0, 0, 0, ll, (40, 56))]),
             animation((30, 40), [(2, 4, 0, lossy, (37, 53))]),
             animation((37, 53), [(0, 0, 0, lossy, (37, 53))]),
             animation((50, 60), [])]
    full = animation((50, 60), [(4, 6, 0, ll, (37, 53)),
                                (0, 0, 0, lossy, (37, 53))])
    cases += [full[:n] for n in range(0, len(full), 131)]
    got = [same_as_cv2(tmp_path, data) for data in cases]
    assert [g is None for g in got[:5]] == [False, False, True, False, True]


# --------------------------------------------------- damage and layout
def _grown(data: bytes, extra: bytes) -> bytes:
    """``data`` with ``extra`` after it, inside its RIFF size."""
    return (data[:4] + struct.pack("<I", len(data) - 8 + len(extra))
            + data[8:] + extra)


def test_riff_size_and_short_files_as_cv2_reads_them(tmp_path):
    """A RIFF size past the file or short of the image gives None; bytes
    after it are ignored; bytes inside it after a still image's chunk are
    too, but they keep an EXIF chunk from being read (and an animation
    from being read at all) unless they make whole chunks; a file under
    32 bytes is no WebP to OpenCV."""
    rgb = image((37, 53), "scene")
    data = cv2_lossless(rgb)
    size = len(data) - 8
    ex = Image.Exif()
    ex[0x0112] = 6
    turned = pil_bytes(Image.fromarray(rgb), "WEBP", lossless=True,
                       exif=ex.tobytes())
    anim = animation((50, 60), [(4, 6, 0, still_chunks(data), (37, 53))])
    tiny = pil_bytes(Image.fromarray(image((1, 1), "scene")), "WEBP",
                     lossless=True, method=6, quality=100)
    assert len(tiny) < 32
    cases = {
        "bigger": data[:4] + struct.pack("<I", size + 100) + data[8:],
        "smaller": data[:4] + struct.pack("<I", size - 2) + data[8:],
        "junk after": data + b"junkjunk",
        "junk inside": _grown(data, b"\xff" * 7),
        "exif, junk inside": _grown(turned, b"\0"),
        "exif, empty chunk inside": _grown(turned, bytes(8)),
        "animation, junk inside": _grown(anim, bytes(7)),
        "animation, empty chunk inside": _grown(anim, bytes(8)),
        "under 32 bytes": tiny}
    got = {k: same_as_cv2(tmp_path, v) for k, v in cases.items()}
    assert [k for k, v in got.items() if v is None] == [
        "bigger", "smaller", "animation, junk inside", "under 32 bytes"]
    assert got["exif, junk inside"].shape == (37, 53, 3)
    assert got["exif, empty chunk inside"].shape == (53, 37, 3)


def grainy(hw, seed=3):
    """The scene with noise, so that lossy VP8 spends a kilobyte on it."""
    rgb = image(hw, "scene").astype(int)
    rng = np.random.default_rng(seed)
    return (rgb + rng.integers(-40, 40, rgb.shape)).clip(0, 255).astype(
        np.uint8)


def with_alpha(rgb):
    h, w = rgb.shape[:2]
    return np.dstack([rgb, (np.arange(h * w).reshape(h, w) % 255).astype(
        np.uint8)])


@pytest.mark.parametrize("source", ["cv2", "pillow_m6", "palette16",
                                    "smooth", "animated", "lossy_cv2",
                                    "lossy_alpha", "lossy_animated"])
def test_truncated_and_bit_flipped_files_equal_cv2(tmp_path, source):
    """Cuts at every 23rd byte and 120 single-bit flips in the stream: the
    port gives what cv2 gives, None included (libwebp's checks: complete
    prefix codes, distances inside the image, no read past the data it
    is given, which runs to the end of the file for a still image and to
    the end of the ANMF chunk for a frame).  Lossy sources (cv2's q80, a
    VP8X with ALPH from Pillow, a lossy animation frame) take libwebp's
    VP8 refusals: the frame tag, the partition table, a header, partition
    0 or macroblock that needs a byte past its partition, and a lossy
    image's ALPH chunk, which libwebp decodes though OpenCV drops it."""
    rgb = image((37, 53), "scene")
    lossy = lambda: cv2.imencode(  # noqa: E731
        ".webp", np.ascontiguousarray(grainy((37, 53))[..., ::-1]),
        [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()
    data = {
        "lossy_cv2": lossy,
        "lossy_alpha": lambda: pil_bytes(
            Image.fromarray(with_alpha(grainy((37, 53)))), "WEBP",
            quality=80),
        "lossy_animated": lambda: animation(
            (41, 57), [(2, 2, 0, still_chunks(lossy()), (37, 53))]),
        "cv2": lambda: cv2_lossless(rgb),
        "pillow_m6": lambda: pil_bytes(Image.fromarray(rgb), "WEBP",
                                       lossless=True, method=6, quality=100),
        "palette16": lambda: pil_bytes(Image.fromarray(rgb).quantize(16),
                                       "WEBP", lossless=True),
        "smooth": lambda: cv2_lossless(smooth_image(90, 160)),
        "animated": lambda: animation(
            (41, 57), [(2, 2, 0, still_chunks(cv2_lossless(rgb)), (37, 53))]),
    }[source]()
    rng = np.random.default_rng(len(data))
    results = []
    for n in range(0, len(data), 23):
        results.append(same_as_cv2(tmp_path, data[:n]))
    for _ in range(120):
        b = bytearray(data)
        i = int(rng.integers(20, len(b)))
        b[i] ^= 1 << int(rng.integers(0, 8))
        results.append(same_as_cv2(tmp_path, bytes(b)))
    assert any(r is None for r in results)
    assert any(r is not None for r in results)


# ------------------------------------------------------- numpy writers
@pytest.mark.parametrize("hw", SIZES + ((120, 160),))
def test_numpy_webp_writers_give_the_frame_and_equal_cv2(tmp_path, hw):
    """testing/photos.py's lossless WebP (subtract-green, predictor,
    normal prefix codes) and its two-frame animation decode to the frame,
    as cv2 reads them."""
    for kind in ("scene", "noise"):
        rgb = image(hw, kind)
        for data in (photos.encode_webp_lossless(rgb),
                     photos.encode_webp_animated(rgb)):
            np.testing.assert_array_equal(same_as_cv2(tmp_path, data), rgb)


# ---------------------------------------------------------- slam_main
def test_slam_main_on_lossless_webp_against_jax(tmp_path, no_native):
    """The hallway at 540x960, 14 frames as lossless WebP (cv2's writer,
    Pillow's, the numpy still and animated writers, cycled): the port (its
    own readers) and the JAX package (cv2.imread) track the same frames,
    ATE within 0.02 of the extent."""
    from test_torch_video import _rel_ate

    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=7, baseline=0.25, kind="hallway")
    writers = (cv2_lossless,
               lambda f: pil_bytes(Image.fromarray(f), "WEBP", lossless=True,
                                   method=0, quality=0),
               photos.encode_webp_lossless, photos.encode_webp_animated)
    for i in range(14):
        (tmp_path / f"frame_{i:02d}.webp").write_bytes(
            writers[i % len(writers)](scene.render(i)))
    pattern = tmp_path / "frame_*.webp"
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
