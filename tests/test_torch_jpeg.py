"""The port's baseline JPEG decoder (io/jpeg.py, native/jpeg.cpp, no
libjpeg) against cv2 (libjpeg-turbo with its defaults) on the CPU: bit for
bit over qualities, sampling factors, grayscale, restart intervals,
optimized tables, odd sizes and a stream without DHT; the processes it
refuses; truncated and corrupt data; the photo MediaSource without the
native decoder against the JAX package's; the numpy JPEG writer that
chip_smoke.py uses (testing/mjpeg.py) against cv2; and the committed
fixtures whose cv2 decode the card's check holds the decoder to.

Rewrite the fixtures with ``python tests/test_torch_jpeg.py
--write-fixtures`` (needs cv2)."""

import hashlib
import json
import pathlib
import sys

import cv2
import numpy as np
import pytest

from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch.io import jpeg, media, native
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "jpeg_fixtures")
_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _scene_image(h, w, seed=7):
    img = make_scene(n_points=300, n_frames=1, seed=seed,
                     baseline=0.3).render(0)
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


@pytest.fixture(scope="module")
def images():
    return {(h, w): _scene_image(h, w) for h, w in ((37, 53), (540, 960))}


def strip_dht(data: bytes) -> bytes:
    """The JPEG without its DHT segments (as Motion-JPEG frames come)."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + data[pos:])


def encode(img_rgb, quality=95, mode="420", progressive=False):
    """cv2.imencode of an RGB image: ``mode`` a sampling ("444" ...),
    "gray", "rst" (restart every 3 MCUs) or "opt" (optimized tables);
    progressive in libjpeg's default scan script with ``progressive``."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    src = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR)
    if mode == "gray":
        src = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2GRAY)
    elif mode == "rst":
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
    elif mode == "opt":
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[mode]]
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def cv2_rgb(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


_CASES = [(hw, q, m) for hw in ((37, 53), (540, 960)) for q in (50, 95, 100)
          for m in ("444", "422", "420", "440", "411", "gray", "rst", "opt")]
_CASES += [(hw, 90, "nodht") for hw in ((37, 53), (540, 960))]


@pytest.mark.parametrize("hw,quality,mode", _CASES,
                         ids=[f"{h}x{w}-q{q}-{m}" for (h, w), q, m in _CASES])
def test_decoder_equals_cv2_bit_for_bit(images, hw, quality, mode):
    """Every case decodes to cv2.imread's pixels (as RGB) exactly; the
    "nodht" file has its DHT stripped, and both take the Annex K tables."""
    data = encode(images[hw], quality, "420" if mode == "nodht" else mode)
    if mode == "nodht":
        data = strip_dht(data)
        assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    want = cv2_rgb(data)
    got = jpeg.decode(data)
    assert got is not None and got.dtype == np.uint8
    assert got.shape == want.shape == hw + (3,)
    np.testing.assert_array_equal(got, want)


def test_decoder_equals_cv2_on_noise_and_wrapping_coefficients():
    """Uniform noise at quality 100 drives the IDCT to its range-limit
    table's edges."""
    rng = np.random.default_rng(3)
    for mode in ("444", "420"):
        img = rng.integers(0, 256, (61, 77, 3), dtype=np.uint8)
        data = encode(img, 100, mode)
        np.testing.assert_array_equal(jpeg.decode(data), cv2_rgb(data))


def _patch_sof(data: bytes, marker: int = None, precision: int = None,
               components: int = None):
    i = data.index(b"\xff\xc2" if b"\xff\xc2" in data else b"\xff\xc0")
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if components is not None:
        b[i + 9] = components
    return bytes(b)


def test_progressive_decodes_to_cv2s_pixels(images):
    """A progressive file (SOF2), refused before progressive decoding came
    in, now decodes to cv2.imread's pixels (tests/test_torch_progjpeg.py
    holds every variant)."""
    data = encode_progressive(images[37, 53])
    np.testing.assert_array_equal(jpeg.decode(data), cv2_rgb(data))


@pytest.mark.parametrize("make,named", [
    (lambda img: _patch_sof(encode_progressive(img), precision=12),
     "12-bit sample precision (SOF2)"),
    (lambda img: _patch_sof(encode(img), components=4),
     "4-component (CMYK/YCCK) JPEG"),
    (lambda img: _patch_sof(encode(img), 0xC9),
     "arithmetic-coded sequential JPEG (SOF9)"),
    (lambda img: _patch_sof(encode(img), 0xCA),
     "arithmetic-coded progressive JPEG (SOF10)"),
    (lambda img: _patch_sof(encode(img), 0xC3), "lossless JPEG (SOF3)"),
    (lambda img: _patch_sof(encode(img), 0xC5), "hierarchical JPEG (SOF5)"),
    (lambda img: _patch_sof(encode(img), precision=12), "12-bit sample"),
])
def test_refused_processes_raise_naming_themselves(images, make, named):
    with pytest.raises(ValueError, match=named.replace("(", r"\(")
                       .replace(")", r"\)")):
        jpeg.decode(make(images[37, 53]))


def encode_progressive(img):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    return buf.tobytes()


def test_truncated_and_corrupt_data_decode_to_none(images, tmp_path):
    """The strict decode (``lenient`` off) gives None for cut and corrupt
    data; ``imread_rgb``, a photo file's reading, gives what cv2.imread
    gives for the cut file (libjpeg-turbo's zero fill past the cut)."""
    data = encode(images[540, 960], 95)
    for cut in (len(data) // 4, len(data) // 2, len(data) - 200):
        assert jpeg.decode(data[:cut]) is None
    assert jpeg.decode(b"\xff\xd8" + bytes(100)) is None
    assert jpeg.decode(b"not a jpeg at all") is None
    # a restart marker out of sequence
    rst = bytearray(encode(images[540, 960], 95, "rst"))
    i = rst.index(b"\xff\xd1")
    rst[i + 1] = 0xD5
    assert jpeg.decode(bytes(rst)) is None
    # a file that ends after its last scan but before EOI still decodes
    np.testing.assert_array_equal(jpeg.decode(data[:-2]), cv2_rgb(data))
    p = tmp_path / "cut.jpg"
    p.write_bytes(data[: len(data) // 2])
    want = cv2.imread(str(p), cv2.IMREAD_COLOR)
    assert want is not None
    np.testing.assert_array_equal(jpeg.imread_rgb(str(p)), want[..., ::-1])


@pytest.fixture
def no_native(monkeypatch):
    """As on a machine where the native (libjpeg) decoder does not build."""
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "g++: jpeglib.h: No such file")


@pytest.mark.parametrize("threads", [1, 3])
def test_media_source_jpeg_without_native_equals_jax(tmp_path, no_native,
                                                     threads):
    """A JPEG glob through the port's MediaSource with the native decoder
    forced off (io/jpeg.py in the thread pool) against the JAX package's
    MediaSource (native libjpeg): the same frames, bit for bit, in natural
    order; a truncated file is kept, as the native reader and cv2.imread
    keep it (libjpeg-turbo fills the cut with zero bits), and equals the
    JAX package's frame of it."""
    sc = make_scene(n_points=300, n_frames=8, seed=5, baseline=0.3)
    for i in range(8):
        cv2.imwrite(str(tmp_path / f"f{i}.jpg"),
                    cv2.cvtColor(sc.render(i), cv2.COLOR_RGB2BGR))
    pattern = str(tmp_path / "*.jpg")
    want = list(JMediaSource(photos_pattern=pattern, threads=3))
    assert not native.available()
    got = list(MediaSource(photos_pattern=pattern, threads=threads,
                           prefetch=3))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    data = (tmp_path / "f3.jpg").read_bytes()
    (tmp_path / "f3.jpg").write_bytes(data[: len(data) // 2])
    want = list(JMediaSource(photos_pattern=pattern, threads=3))
    got = list(MediaSource(photos_pattern=pattern, threads=threads))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[3], got[2])


def test_decoder_build_failure_raises_with_the_compilers_message(
        tmp_path, monkeypatch, no_native):
    bad = tmp_path / "jpeg.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(jpeg, "SOURCE", bad)
    monkeypatch.setattr(jpeg, "LIBRARY", tmp_path / "_build" / "lib.so")
    monkeypatch.setitem(jpeg._state, "lib", None)
    monkeypatch.setitem(jpeg._state, "error", None)
    cv2.imwrite(str(tmp_path / "x.jpg"), np.zeros((8, 8, 3), np.uint8))
    for _ in range(2):                   # and on every later call
        with pytest.raises(RuntimeError, match="no_such_header_here"):
            media._imread_rgb(str(tmp_path / "x.jpg"))


# ------------------------------------------------- the numpy JPEG writer
@pytest.mark.parametrize("dht", [True, False])
@pytest.mark.parametrize("hw", [(37, 53), (540, 960)])
def test_writer_files_decode_as_cv2_decodes_them(images, hw, dht):
    """testing/mjpeg.encode_jpeg (chip_smoke.py's JPEG writer): cv2 reads
    its files, to the port decoder's pixels exactly, close to the source."""
    data = mjpeg.encode_jpeg(images[hw], 95, dht=dht)
    want = cv2_rgb(data)
    assert want is not None
    np.testing.assert_array_equal(jpeg.decode(data), want)
    err = np.abs(want.astype(int) - images[hw]).mean()
    assert err < 3.0, err


def test_writer_tables_are_cv2s_quality_95_tables(images):
    """The writer's DQT and DHT payloads equal cv2's at quality 95 (libjpeg's
    scaled tables and Annex K's Huffman tables)."""
    def payloads(data, marker):
        out, pos = b"", 2
        while data[pos + 1] != 0xDA:
            n = int.from_bytes(data[pos + 2:pos + 4], "big")
            if data[pos + 1] == marker:
                out += data[pos + 4:pos + 2 + n]
            pos += 2 + n
        return out

    ours = mjpeg.encode_jpeg(images[37, 53], 95)
    theirs = encode(images[37, 53], 95)
    for marker in (0xDB, 0xC4):
        assert payloads(ours, marker) == payloads(theirs, marker)


# ------------------------------------------- fixtures for the card check
def _fixture_specs():
    """(name, encoded bytes) of each fixture, written by cv2."""
    hall = _scene_image(240, 320)
    noise = np.random.default_rng(11).integers(0, 256, (37, 53, 3),
                                               dtype=np.uint8)
    return [
        ("hall_420_q95.jpg", encode(hall, 95, "420")),
        ("hall_444_q100_rst.jpg", encode(hall[:120, :160], 100, "rst")),
        ("noise_422_q50_opt.jpg", encode(noise, 50, "opt")),
        ("hall_440_q75.jpg", encode(hall[:90, :130], 75, "440")),
        ("hall_411_q90.jpg", encode(hall[:64, :100], 90, "411")),
        ("hall_gray_q90.jpg", encode(hall[:120, :160], 90, "gray")),
        ("hall_420_q85_nodht.jpg", strip_dht(encode(hall[:120, :160], 85))),
        ("hall_prog_420_q95.jpg", encode(hall, 95, progressive=True)),
        ("hall_prog_420_q80_rst_cut3.jpg", _cut_after_scans(
            encode(hall[:120, :160], 80, "rst", progressive=True), 3)),
        ("noise_prog_422_q100_cut6.jpg", _cut_after_scans(
            encode(noise, 100, "422", progressive=True), 6)),
    ]


def _cut_after_scans(data: bytes, k: int) -> bytes:
    """The first k scans of a progressive file, EOI appended (libjpeg
    then smooths the blocks the cut script leaves short)."""
    pos, seen = 2, 0
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            seen += 1
            if seen > k:
                return data[:pos] + b"\xff\xd9"
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:               # past the entropy-coded data
            while not (data[pos] == 0xFF and data[pos + 1] not in (
                    0x00, 0xFF, *range(0xD0, 0xD8))):
                pos += 1


def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write_fixtures() -> None:
    FIXTURES.mkdir(exist_ok=True)
    table = {}
    for name, data in _fixture_specs():
        (FIXTURES / name).write_bytes(data)
        img = cv2_rgb(data)
        table[name] = {"shape": list(img.shape), "sha256": _sha(img)}
    (FIXTURES / "cv2_sha256.json").write_text(
        json.dumps(table, indent=1, sort_keys=True) + "\n")


def test_committed_fixtures_hold_cv2s_decode_and_the_decoder_equals_it():
    """The committed fixtures' JSON is cv2's decode of each file (as RGB),
    and the port's decoder gives the same sha256: the check chip_smoke.py
    makes on the card, where there is no cv2."""
    table = json.loads((FIXTURES / "cv2_sha256.json").read_text())
    assert len(table) == 10
    total = 0
    for name, want in table.items():
        data = (FIXTURES / name).read_bytes()
        total += len(data)
        assert _sha(cv2_rgb(data)) == want["sha256"], name
        got = jpeg.decode(data)
        assert list(got.shape) == want["shape"]
        assert _sha(got) == want["sha256"], name
    assert total < 300_000


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_fixtures()
