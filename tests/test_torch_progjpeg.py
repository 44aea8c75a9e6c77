"""The port's progressive JPEG decoding (io/jpeg.py over native/jpeg.cpp,
no libjpeg) against cv2.imread (libjpeg-turbo 3.1 with its defaults) on the
CPU: bit for bit over 4:2:0, 4:2:2, 4:4:4, 4:4:0, 4:1:1 and gray, q50 to
q100, restart intervals and sizes that are not whole blocks or MCUs, each
file complete and cut at every scan boundary (EOI appended), where
libjpeg-turbo's block smoothing estimates the coefficients the cut script
left unsent; a DHT between scans; the scan parameters libjpeg refuses and
the processes the decoder refuses; the numpy progressive writer
chip_smoke.py uses (testing/mjpeg.py); the photo MediaSource without the
native reader against the JAX package's (its system libjpeg differs from
libjpeg-turbo 3.1 by a stated 2 grey levels on cut files); and slam_main on
a progressive photo glob against the JAX package's."""

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io import jpeg, native
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg

from test_torch_jpeg import _SAMPLING, cv2_rgb
from test_torch_video import _rel_ate

torch.set_num_threads(1)


def encode_progressive(img_rgb, quality=95, mode="420"):
    """cv2.imencode with IMWRITE_JPEG_PROGRESSIVE (libjpeg's
    jpeg_simple_progression): ``mode`` a sampling, "gray" or "rst"
    (restart every 2 MCUs, 4:2:0)."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    src = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR)
    if mode == "gray":
        src = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2GRAY)
    elif mode == "rst":
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[mode]]
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def segments(data: bytes):
    """(marker, offset) of each marker segment before EOI, entropy-coded
    data skipped."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) or \
                0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xD9:
            break
        out.append((m, pos))
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return out


def scan_starts(data: bytes) -> list:
    return [p for m, p in segments(data) if m == 0xDA]


def cut_after(data: bytes, k: int) -> bytes:
    """The first k scans (and what precedes the next), EOI appended."""
    return data[:scan_starts(data)[k]] + b"\xff\xd9"


def scan_script(data: bytes) -> list:
    """(component ids, Ss, Se, Ah, Al) of each SOS."""
    out = []
    for m, p in segments(data):
        if m == 0xDA:
            ns = data[p + 4]
            ids = tuple(data[p + 5 + 2 * i] for i in range(ns))
            ss, se, a = data[p + 5 + 2 * ns:p + 8 + 2 * ns]
            out.append((ids, ss, se, a >> 4, a & 15))
    return out


def _scene_image(h, w, seed=7):
    img = make_scene(n_points=300, n_frames=1, seed=seed,
                     baseline=0.3).render(0)
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


@pytest.fixture(scope="module")
def images():
    return {hw: _scene_image(*hw) for hw in ((37, 53), (61, 77), (270, 480))}


_MODES = ("420", "422", "444", "440", "411", "gray", "rst")
_CASES = [(hw, q, m) for hw in ((37, 53), (61, 77), (270, 480))
          for q in (50, 75, 95, 100) for m in _MODES]


@pytest.mark.parametrize("hw,quality,mode", _CASES,
                         ids=[f"{h}x{w}-q{q}-{m}" for (h, w), q, m in _CASES])
def test_progressive_equals_cv2_complete_and_cut_at_every_scan(
        images, hw, quality, mode):
    """The file and each of its cut scripts decode to cv2.imread's pixels
    exactly: the complete script with no smoothing, a cut one with
    libjpeg-turbo's block smoothing (the DC too while no AC was sent)."""
    data = encode_progressive(images[hw], quality, mode)
    n = len(scan_starts(data))
    assert n == (6 if mode == "gray" else 10)
    for k in range(1, n + 1):
        d = data if k == n else cut_after(data, k)
        want = cv2_rgb(d)
        got = jpeg.decode(d)
        assert got is not None and got.shape == hw + (3,), k
        np.testing.assert_array_equal(got, want, err_msg=f"scans {k}")


@pytest.mark.parametrize("hw", [(35, 9), (8, 1), (1, 200)])
def test_narrow_and_flat_pictures(hw):
    """One block or one MCU wide or high: the smoothing's clamped
    neighbourhood; noise, cut after 1, 2 and 5 scans and complete."""
    img = np.random.default_rng(hw[0] * 7 + hw[1]).integers(
        0, 256, hw + (3,), dtype=np.uint8)
    data = encode_progressive(img, 80, "420")
    for d in (cut_after(data, 1), cut_after(data, 2), cut_after(data, 5),
              data):
        np.testing.assert_array_equal(jpeg.decode(d), cv2_rgb(d))


def test_noise_at_quality_100_drives_every_refinement():
    """Uniform noise: large coefficients, long zero runs rare, every
    refinement bit and newly nonzero coefficient; 4:4:4 and 4:2:0."""
    rng = np.random.default_rng(5)
    for mode in ("444", "420"):
        img = rng.integers(0, 256, (64, 91, 3), dtype=np.uint8)
        data = encode_progressive(img, 100, mode)
        for k in (4, 6, 9):
            d = cut_after(data, k)
            np.testing.assert_array_equal(jpeg.decode(d), cv2_rgb(d))
        np.testing.assert_array_equal(jpeg.decode(data), cv2_rgb(data))


def test_dht_between_scans_is_read():
    """libjpeg writes each scan's optimised Huffman table in a DHT before
    that scan: the decoder takes every redefinition (the file equals cv2's
    decode only if it does)."""
    img = _scene_image(120, 160)
    data = encode_progressive(img, 90)
    marks = [m for m, _ in segments(data)]
    first_sos = marks.index(0xDA)
    assert 0xC4 in marks[first_sos:]
    np.testing.assert_array_equal(jpeg.decode(data), cv2_rgb(data))


def test_scan_script_is_libjpegs_simple_progression():
    """cv2's progressive files carry libjpeg's default script, which the
    numpy writer copies (``mjpeg.SIMPLE_PROGRESSION``)."""
    img = _scene_image(48, 64)
    want = [(tuple(c + 1 for c in comps), ss, se, ah, al)
            for comps, ss, se, ah, al in mjpeg.SIMPLE_PROGRESSION]
    assert scan_script(encode_progressive(img)) == want
    assert scan_script(mjpeg.encode_progressive_jpeg(img)) == want


def _patch_scan(data: bytes, k: int, ss=None, se=None, a=None) -> bytes:
    p = scan_starts(data)[k]
    ns = data[p + 4]
    b = bytearray(data)
    q = p + 5 + 2 * ns
    for off, v in ((0, ss), (1, se), (2, a)):
        if v is not None:
            b[q + off] = v
    return bytes(b)


@pytest.mark.parametrize("k,fields", [
    (0, dict(se=5)),              # a DC scan with an AC band
    (1, dict(ss=6, se=5)),        # Ss > Se
    (1, dict(se=64)),             # Se past the block
    (0, dict(a=0x02)),            # Ah 0, Al 2: legal
    (5, dict(a=0x31)),            # a refinement with Al != Ah - 1
    (0, dict(a=0x0E)),            # Al > 13
])
def test_bad_progression_is_refused_as_libjpeg_refuses_it(images, k, fields):
    """Scan parameters libjpeg stops at (JERR_BAD_PROGRESSION): cv2 reads
    nothing, the port decodes to None; Al = 2 on the first DC scan is
    legal and both decode it alike."""
    data = _patch_scan(encode_progressive(images[37, 53]), k, **fields)
    want = cv2_rgb(data)
    if fields == dict(a=0x02):
        assert want is not None
        np.testing.assert_array_equal(jpeg.decode(data), want)
        return
    assert want is None
    assert jpeg.decode(data) is None


def test_an_ac_scan_of_two_components_is_refused():
    img = _scene_image(32, 32)
    data = bytearray(encode_progressive(img, 90, "444"))
    p = scan_starts(bytes(data))[0]               # the DC scan of 1, 2, 3
    data[p + 11] = 1                              # ... given Ss = 1
    assert cv2_rgb(bytes(data)) is None
    assert jpeg.decode(bytes(data)) is None


def _patch_sof2(data: bytes, marker=None, precision=None) -> bytes:
    i = data.index(b"\xff\xc2")
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


@pytest.mark.parametrize("make,named", [
    (lambda d: _patch_sof2(d, 0xCA),
     r"arithmetic-coded progressive JPEG \(SOF10\)"),
    (lambda d: _patch_sof2(d, precision=12),
     r"12-bit sample precision \(SOF2\)"),
])
def test_refused_progressive_processes_raise_naming_themselves(images, make,
                                                               named):
    with pytest.raises(ValueError, match=named):
        jpeg.decode(make(encode_progressive(images[37, 53])))


def test_truncated_progressive_decodes_to_none(images):
    """Cut inside a scan (no EOI): None from the strict decode, as for a
    baseline file."""
    data = encode_progressive(images[270, 480], 95)
    for cut in (scan_starts(data)[2] + 40, len(data) // 2, len(data) - 20):
        assert jpeg.decode(data[:cut]) is None


@pytest.mark.parametrize("where", ["third scan", "half", "end"])
def test_truncated_progressive_recovers_as_cv2(images, tmp_path, where):
    """The strict test's cuts read with ``lenient`` (a photo's reading):
    libjpeg-turbo's fake EOI, the cut scan kept as far as its data goes,
    then block smoothing by its bookkeeping of a scan that did not
    finish; equal to cv2.imread of the cut file."""
    data = encode_progressive(images[270, 480], 95)
    cut = {"third scan": scan_starts(data)[2] + 40, "half": len(data) // 2,
           "end": len(data) - 20}[where]
    p = tmp_path / "cut.jpg"
    p.write_bytes(data[:cut])
    want = cv2.imread(str(p), cv2.IMREAD_COLOR)
    assert want is not None
    np.testing.assert_array_equal(jpeg.decode(data[:cut], lenient=True),
                                  want[..., ::-1])


# ------------------------------------------------------- the numpy writer
@pytest.mark.parametrize("hw", [(37, 53), (270, 480)])
@pytest.mark.parametrize("quality", [50, 95, 100])
def test_writer_decodes_to_the_baseline_writers_pixels(images, hw, quality):
    """testing/mjpeg.encode_progressive_jpeg (chip_smoke.py's progjpeg
    writer): its coefficients are encode_jpeg's, so cv2 decodes both files
    to the same pixels, and so does the port, cut scripts included; on
    noise too (long and short end-of-band runs, correction bits)."""
    rng = np.random.default_rng(quality)
    for img in (images[hw], rng.integers(0, 256, hw + (3,), np.uint8)):
        prog = mjpeg.encode_progressive_jpeg(img, quality)
        base = cv2_rgb(mjpeg.encode_jpeg(img, quality))
        np.testing.assert_array_equal(cv2_rgb(prog), base)
        np.testing.assert_array_equal(jpeg.decode(prog), base)
        for k in (1, 3, 6):
            d = cut_after(prog, k)
            np.testing.assert_array_equal(jpeg.decode(d), cv2_rgb(d))


def test_optimal_table_is_a_canonical_table_within_16_bits():
    """Fibonacci counts, for which Huffman's procedure gives codes up to 25
    bits: the table is cut to 16 and codes every counted symbol."""
    fib = [1, 1]
    while len(fib) < 26:
        fib.append(fib[-1] + fib[-2])
    freq = np.zeros(256, np.int64)
    freq[:26] = fib
    bits, vals = mjpeg.optimal_table(freq)
    assert len(bits) == 16 and sum(bits) == len(vals) == 26
    assert sorted(vals) == list(range(26))
    kraft = sum(n / 2 ** (i + 1) for i, n in enumerate(bits))
    assert kraft < 1.0


# ------------------------------------------------------------- the photos
@pytest.fixture
def no_native(monkeypatch):
    """As on the card machine, where the libjpeg reader does not build."""
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "g++: jpeglib.h: No such file")


def test_media_source_equals_jax_on_progressive_photos(tmp_path, no_native):
    """A progressive photo glob through the port's MediaSource (io/jpeg.py)
    against the JAX package's (its native reader over the system libjpeg):
    complete files equal bit for bit; files cut at a scan boundary within 2
    grey levels (the system libjpeg's smoothing is older than
    libjpeg-turbo 3.1's, which the port equals)."""
    sc = make_scene(n_points=300, n_frames=6, seed=5, baseline=0.3)
    for i in range(6):
        data = encode_progressive(sc.render(i), 90)
        (tmp_path / f"f{i}.jpg").write_bytes(data)
        (tmp_path / f"c{i}.jpg").write_bytes(cut_after(data, 1 + i))
    assert not native.available()
    for prefix, tol in (("f", 0), ("c", 2)):
        pattern = str(tmp_path / f"{prefix}*.jpg")
        want = list(JMediaSource(photos_pattern=pattern, threads=3))
        got = list(MediaSource(photos_pattern=pattern, threads=3))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert np.abs(a.astype(int) - b).max() <= tol


def _photo_cfg(mod, pattern, out):
    """test_torch_video.py's _cfg over a photo glob."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12)
    return mod.Config(
        usePhotosCycle=True, photosPathPattern=str(pattern),
        outputDataDir=str(out), requiredExtractedPointsCount=80,
        featureExtractingThreshold=20, framesBatchSize=6,
        requiredMatchedPointsCount=30, knnMatcherDistance=0.8,
        RPDistanceThreshold=500.0, useBundleAdjustment=True,
        BAMaxFramesCnt=4, BAUseHuberLossFunction=True,
        BAHuberLossFunctionParameter=2.0, threadsCount=3, tpu=tpu)


def test_slam_main_on_progressive_photos_against_jax(tmp_path, no_native):
    """The headline hallway at 540x960, 14 frames as progressive q95
    photos: the port (its own decoder) and the JAX package (libjpeg) read
    the same frames, track the same frames, ATE within 0.02 of the
    extent."""
    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=7, baseline=0.25, kind="hallway")
    for i in range(14):
        (tmp_path / f"img{i}.jpg").write_bytes(
            mjpeg.encode_progressive_jpeg(scene.render(i), 95))
    pattern = tmp_path / "*.jpg"
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
