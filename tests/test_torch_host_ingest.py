"""The port's host frontend (host ingest) against OpenCV and the JAX
package's, on the CPU: the gray plane, the raw FAST corners, the NMS and
subpixel survivors, the pooled gray and the packed chunk (with the host
ORB bits of "orb" and "hybrid") exactly; the descriptors the device half
computes from them to fp32 tolerance."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.models import frontend as jfe
from slam_indoor_code_tpu.ops import fast as jfast
from slam_indoor_code_tpu.runtime import EngineConfig as JEngineConfig
from slam_indoor_code_tpu.runtime import steps as jsteps
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch.io.media import ArraySource
from slam_indoor_code_tpu_torch.models import frontend as tfe
from slam_indoor_code_tpu_torch.ops import fast as tfast
from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig
from slam_indoor_code_tpu_torch.runtime import steps as tsteps

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rt_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


@pytest.fixture(scope="module")
def gray_frames(rt_scene):
    rng = np.random.default_rng(3)
    return {
        "rendered": cv2.cvtColor(rt_scene.render(0), cv2.COLOR_RGB2GRAY),
        "noise": rng.integers(0, 256, (240, 320), dtype=np.uint8),
        "black": np.zeros((120, 160), np.uint8),
    }


def test_host_gray_equals_cv2_on_every_rgb_value():
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(tfe.host_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("d", [2, 3])
def test_area_downscale_equals_cv2(d):
    rng = np.random.default_rng(d)
    for H, W in ((240, 318), (1080, 1920)):
        H, W = H - H % d, W - W % d
        g = rng.integers(0, 256, (H, W), dtype=np.uint8)
        want = cv2.resize(g, (W // d, H // d), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(tfe.area_downscale(g, d), want)


def test_area_downscale_refuses_a_ragged_plane():
    with pytest.raises(ValueError, match="multiple"):
        tfe.area_downscale(np.zeros((11, 12), np.uint8), 2)


@pytest.mark.parametrize("kind", ["rendered", "noise", "black"])
@pytest.mark.parametrize("threshold", [20, 15, 5])
def test_raw_corners_equal_cv2_in_order(gray_frames, kind, threshold):
    gray = gray_frames[kind]
    det = cv2.FastFeatureDetector_create(
        threshold=threshold, nonmaxSuppression=False,
        type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16)
    kps = det.detect(gray)
    want = (cv2.KeyPoint_convert(kps) if kps else np.zeros((0, 2))).astype(
        np.int64)
    xs, ys, score = tfast.raw_corners(gray, threshold)
    np.testing.assert_array_equal(np.stack([xs, ys], -1).reshape(-1, 2),
                                  want)
    # the dense score map's corners and scores at the same threshold
    dense = tfast.fast_score_map(torch.from_numpy(gray).float(),
                                 float(threshold)).numpy()
    assert int((dense > 0).sum()) == len(xs)
    np.testing.assert_array_equal(dense[ys, xs], score.astype(np.float32))
    # a CPU tensor gives the same list
    xs2, ys2, _ = tfast.raw_corners(torch.from_numpy(gray), threshold)
    np.testing.assert_array_equal(xs2, xs)
    np.testing.assert_array_equal(ys2, ys)


@pytest.mark.parametrize("kind,threshold", [("rendered", 20.0),
                                            ("rendered", 5.0),
                                            ("noise", 15.0),
                                            ("black", 20.0)])
def test_host_detect_frame_equals_jax(gray_frames, kind, threshold):
    gray = gray_frames[kind]
    jxy, jixy, jn = jfe._host_detect_frame(gray, threshold)
    txy, tixy, tn = tfe._host_detect_frame(gray, threshold)
    assert tn == jn
    np.testing.assert_array_equal(tixy, jixy)
    np.testing.assert_array_equal(txy, jxy)


def test_host_detect_matches_device_detector(rt_scene):
    """tests/test_runtime.py's test_host_detect_matches_device_detector on
    the port: the host detector gives the device detector's corner set,
    subpixel coords and post-NMS count."""
    gray = tfe.host_gray(rt_scene.render(0))
    d = tfast.detect(torch.from_numpy(gray).float(), 20.0, 4096)
    dxy = d["xy"].numpy()[d["valid"].numpy()]
    hxy, _ixy, hn = tfe._host_detect_frame(gray, 20.0)
    assert hn == int(d["num_corners"])
    assert len(hxy) == len(dxy)
    ds = dxy[np.lexsort((dxy[:, 0], dxy[:, 1]))]
    hs = hxy[np.lexsort((hxy[:, 0], hxy[:, 1]))]
    np.testing.assert_allclose(ds, hs, atol=1e-4)
    # and the JAX package's device detector agrees on the count
    jd = jfast.detect(jnp.asarray(gray, jnp.float32), 20.0, 4096)
    assert int(jd["num_corners"]) == hn


@pytest.mark.parametrize("d", [1, 2])
def test_host_detect_pack_equals_jax_byte_for_byte(rt_scene, d):
    frames = [rt_scene.render(i) for i in (0, 5, 9)]
    frames.append(np.zeros_like(frames[0]))
    want = jfe.host_detect_pack(frames, 20.0, 512, d, host_desc="same")
    got = tfe.host_detect_pack(frames, 20.0, 512, d, host_desc="same")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["counts"][-1] == 0 and got["counts"][:3].min() > 80


@pytest.mark.parametrize("host_desc", ["orb", "hybrid"])
def test_host_detect_pack_refuses_orb_modes(rt_scene, host_desc):
    """The host ORB modes are no longer refused: the port's packed chunk
    equals the JAX package's (cv2's ORB bits) key for key, byte for byte;
    "orb" ships no gray plane."""
    frames = [rt_scene.render(i) for i in (0, 7)]
    want = jfe.host_detect_pack(frames, 20.0, 256, 1, host_desc=host_desc)
    got = tfe.host_detect_pack(frames, 20.0, 256, 1, host_desc=host_desc)
    assert set(got) == set(want)
    assert ("gray_small" in got) == (host_desc == "hybrid")
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["desc_bits"] != 0).any(-1).sum() > 200


@pytest.mark.parametrize("d,descriptor", [(2, "sift"), (1, "sift"),
                                          (2, "orb")])
def test_ingest_host_matches_jax_describe(rt_scene, d, descriptor):
    """The port's steps.ingest_host against the JAX package's
    describe_packed_batch on one packed chunk: the stored keypoints,
    validity and colours exactly; SIFT descriptors to fp32 tolerance, ORB
    bit words exactly."""
    frames = [rt_scene.render(i) for i in (0, 4, 8)]
    p = jfe.host_detect_pack(frames, 20.0, 256, d, host_desc="same")
    metric = "hamming" if descriptor == "orb" else "l2"
    jcfg = JEngineConfig(max_keypoints=256, ring=6, map_cap=1024, window=4,
                         window_points=256, descriptor=descriptor,
                         metric=metric, ingest_mode="host",
                         ingest_downscale=d, host_desc="same")
    want = np.asarray(jfe.describe_packed_batch(
        jsteps._frontend_cfg(jcfg), jnp.asarray(p["gray_small"]),
        jnp.asarray(p["xy"]), jnp.asarray(p["valid"]), d))
    cfg = EngineConfig(max_keypoints=256, ring=6, map_cap=1024, window=4,
                       window_points=256, descriptor=descriptor,
                       metric=metric, ingest_mode="host", ingest_downscale=d,
                       host_desc="same")
    eng = DeviceEngine(ArraySource(frames), rt_scene.K, cfg, batch_size=4,
                       required_extracted=10, device="cpu")
    # below 1024 px the engine turns pooling off; the step takes d as given
    assert eng.cfg.ingest_downscale == 1
    slots = torch.tensor([4, 1, 2])
    state = tsteps.ingest_host(
        cfg, eng.state, torch.from_numpy(p["gray_small"]),
        torch.from_numpy(p["xy"]), torch.from_numpy(p["valid"]),
        torch.from_numpy(p["colors"]), slots)
    np.testing.assert_array_equal(state.ring_xy[slots].numpy(), p["xy"])
    np.testing.assert_array_equal(state.ring_valid[slots].numpy(),
                                  p["valid"])
    np.testing.assert_array_equal(state.ring_colors[slots].numpy(),
                                  p["colors"].astype(np.float32))
    got = state.ring_desc[slots].numpy()
    if descriptor == "orb":
        np.testing.assert_array_equal(got, want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
