"""The port's host ORB descriptor modes ("orb", "hybrid", and "auto" under
host ingest) against OpenCV and the JAX package's, on the CPU: OpenCV's
pattern as the port holds it, ``host_orb_bits`` bit for bit against
``cv2.ORB_create().compute`` (the JAX package's ``_host_orb_bits``), the
packed chunk, the ring contents ``ingest_host_desc`` and
``ingest_host_hybrid`` write, and the twin of tests/test_runtime.py's
``test_engine_host_descriptor_modes_e2e`` on the streaming and classic
device loops."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io.media import ArraySource as JArraySource
from slam_indoor_code_tpu.models import frontend as jfe
from slam_indoor_code_tpu.runtime import DeviceEngine as JEngine
from slam_indoor_code_tpu.runtime import EngineConfig as JEngineConfig
from slam_indoor_code_tpu.runtime import steps as jsteps
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io.media import ArraySource
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.models import frontend as tfe
from slam_indoor_code_tpu_torch.ops.orb_pattern import BIT_PATTERN_31
from slam_indoor_code_tpu_torch.parallel.mesh import make_mesh
from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig
from slam_indoor_code_tpu_torch.runtime import steps as tsteps

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rt_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


@pytest.fixture(scope="module")
def rt_frames(rt_scene):
    return [rt_scene.render(i) for i in range(14)]


def test_pattern_equals_the_cv2_binary():
    """The committed pattern is the 1024 int32 words OpenCV's library holds
    (found once, by its leading words)."""
    cv2 = pytest.importorskip("cv2")
    libs = sorted(Path(cv2.__file__).parent.glob("cv2*.so"))
    assert libs, "no cv2 shared library beside cv2/__init__.py"
    blob = libs[0].read_bytes()
    lead = np.array([8, -3, 9, 5, 4, 2, 7, -12], np.int32).tobytes()
    at = blob.find(lead)
    assert at >= 0 and blob.find(lead, at + 1) < 0
    words = np.frombuffer(blob[at:at + 4096], np.int32)
    np.testing.assert_array_equal(BIT_PATTERN_31.reshape(-1), words)
    assert BIT_PATTERN_31.shape == (256, 2, 2)
    assert (BIT_PATTERN_31.min(), BIT_PATTERN_31.max()) == (-13, 12)


def test_orb_gaussian_equals_cv2_kernel():
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(
        tfe._ORB_GAUSS7, cv2.getGaussianKernel(7, 2, cv2.CV_32F).ravel())


def _textured(H, W, seed):
    """A rendered hallway frame's gray at H×W, and a smoothed noise plane
    with flat and saturated patches (near-ties in the blur)."""
    sc = make_scene(n_points=1500, n_frames=1, image_size=(H, W), seed=seed,
                    baseline=0.25, kind="hallway")
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (H + 4, W + 4)).astype(np.float64)
    noise = sum(noise[dy:dy + H, dx:dx + W] for dy in range(5)
                for dx in range(5)) / 25.0
    noise = np.rint(noise).astype(np.uint8)
    noise[: H // 4, : W // 4] = 128
    noise[H // 2:, W // 2: W // 2 + 40] = 255
    return {"rendered": tfe.host_gray(sc.render(0)), "noise": noise}


def _keypoints(gray, rng, n_random):
    """The frame's FAST keypoints, random ones on a half-pixel grid, and a
    band 29–33 px from each edge in half-pixel steps (ORB keeps a keypoint
    iff its rounded centre is ≥ 31 px inside)."""
    H, W = gray.shape
    det, _, _ = tfe._host_detect_frame(gray, 20.0)
    rand = np.stack([rng.uniform(0, W - 1, n_random),
                     rng.uniform(0, H - 1, n_random)], -1)
    rand[: n_random // 2] = np.round(rand[: n_random // 2] * 2) / 2
    band = np.arange(29.0, 33.01, 0.5)
    ys = rng.uniform(40, H - 40, len(band))
    xs = rng.uniform(40, W - 40, len(band))
    edges = [np.stack([band, ys], -1), np.stack([W - 1 - band, ys], -1),
             np.stack([xs, band], -1), np.stack([xs, H - 1 - band], -1),
             np.stack([W - band, ys], -1), np.stack([xs, H - band], -1)]
    return np.concatenate([det[:3000], rand] + edges).astype(np.float32)


@pytest.mark.parametrize("size", [(540, 960), (1080, 1920)])
@pytest.mark.parametrize("kind", ["rendered", "noise"])
def test_host_orb_bits_equal_cv2(size, kind):
    """0 differing bits against the JAX package's cv2 ORB, border band and
    half-pixel keypoints included; invalid rows stay zero."""
    pytest.importorskip("cv2")
    gray = _textured(*size, seed=11)[kind]
    rng = np.random.default_rng(size[0])
    xy = _keypoints(gray, rng, 4000)
    valid = rng.random(len(xy)) > 0.05
    K = len(xy) + 16                       # trailing slots hold nothing
    xy = np.concatenate([xy, np.zeros((16, 2), np.float32)])
    valid = np.concatenate([valid, np.zeros(16, bool)])
    want = jfe._host_orb_bits(gray, xy, valid, K)
    got = tfe.host_orb_bits(gray, xy, valid, K)
    assert got.shape == (K, 32) and got.dtype == np.uint8
    assert int(np.unpackbits(got ^ want).sum()) == 0
    kept = (got != 0).any(-1)
    assert kept.sum() > 3000 and not kept[~valid].any()
    H, W = gray.shape
    c = np.rint(xy)
    inside = ((c[:, 0] >= 31) & (c[:, 0] < W - 31) & (c[:, 1] >= 31)
              & (c[:, 1] < H - 31))
    assert not kept[~inside].any()


@pytest.mark.parametrize("host_desc", ["orb", "hybrid"])
def test_host_detect_pack_equals_jax_at_half_fhd(host_desc):
    """The packed chunk at 540×960 with the pooled gray at d=2: the JAX
    package's key for key, byte for byte."""
    frames = [make_scene(n_points=1500, n_frames=3, image_size=(540, 960),
                         seed=7, baseline=0.25, kind="hallway").render(i)
              for i in (0, 2)]
    want = jfe.host_detect_pack(frames, 20.0, 1024, 2, host_desc=host_desc)
    got = tfe.host_detect_pack(frames, 20.0, 1024, 2, host_desc=host_desc)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_host_detect_pack_refuses_an_unknown_mode(rt_frames):
    with pytest.raises(ValueError, match="host descriptor"):
        tfe.host_detect_pack(rt_frames[:1], 20.0, 64, 1, host_desc="auto")


@pytest.mark.parametrize("host_desc,shards", [("orb", 1), ("hybrid", 1),
                                              ("hybrid", 3)])
def test_ingest_host_ring_equals_jax(rt_scene, rt_frames, host_desc, shards):
    """``ingest_host_desc`` / ``ingest_host_hybrid`` against the JAX
    package's steps on one packed chunk (with undistortion): the stored
    validity and colours exactly, the undistorted keypoints to 1e-4 px, the
    bits exactly, the pooled SIFT part to 1e-5; the hybrid chunk split over 3 virtual shards gives
    the same ring."""
    frames = [rt_frames[i] for i in (0, 4, 8)]
    p = jfe.host_detect_pack(frames, 20.0, 256, 1, host_desc=host_desc)
    dist = np.array([0.05, -0.02, 0.0, 0.0, 0.0])
    kw = dict(max_keypoints=256, ring=6, map_cap=1024, window=4,
              window_points=256, ingest_mode="host", ingest_downscale=1,
              host_desc=host_desc, use_undistortion=True)
    jeng = JEngine(JArraySource(frames), rt_scene.K, JEngineConfig(**kw),
                   batch_size=4, required_extracted=10, dist=dist)
    eng = DeviceEngine(ArraySource(frames), rt_scene.K, EngineConfig(**kw),
                       batch_size=4, required_extracted=10, dist=dist,
                       device="cpu")
    assert eng.cfg.host_desc == jeng.cfg.host_desc == host_desc
    slots = np.array([4, 1, 2], np.int32)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    mesh = make_mesh((shards,), devices=[torch.device("cpu")] * shards)
    if host_desc == "orb":
        words = p["desc_bits"].view(np.uint32)
        js = jsteps.ingest_host_desc(
            jeng.cfg, jeng.state, jnp.asarray(words), jnp.asarray(p["xy"]),
            jnp.asarray(p["valid"]), jnp.asarray(p["colors"]),
            jnp.asarray(slots))
        ts = tsteps.ingest_host_desc(
            eng.cfg, eng.state, torch.from_numpy(words.view(np.int32)),
            pt["xy"], pt["valid"], pt["colors"], torch.from_numpy(slots))
    else:
        js = jsteps.ingest_host_hybrid(
            jeng.cfg, jeng.state, jnp.asarray(p["gray_small"]),
            jnp.asarray(p["desc_bits"]), jnp.asarray(p["xy"]),
            jnp.asarray(p["valid"]), jnp.asarray(p["colors"]),
            jnp.asarray(slots))
        ts = tsteps.ingest_host_hybrid(
            eng.cfg, eng.state, pt["gray_small"], pt["desc_bits"], pt["xy"],
            pt["valid"], pt["colors"], torch.from_numpy(slots), mesh)
    sl = torch.from_numpy(slots).long()
    for name in ("ring_valid", "ring_colors"):
        np.testing.assert_array_equal(getattr(ts, name)[sl].numpy(),
                                      np.asarray(getattr(js, name))[slots],
                                      err_msg=name)
    # undistorted coordinates: float32 iterations, to an ulp of 500 px
    np.testing.assert_allclose(ts.ring_xy[sl].numpy(),
                               np.asarray(js.ring_xy)[slots], rtol=0,
                               atol=1e-4)
    got = ts.ring_desc[sl].numpy()
    want = np.asarray(js.ring_desc)[slots]
    if host_desc == "orb":
        assert got.shape[-1] == 8
        np.testing.assert_array_equal(got, want.view(np.int32))
        return
    assert got.shape[-1] == 384
    np.testing.assert_array_equal(got[..., 128:], want[..., 128:])
    np.testing.assert_allclose(got[..., :128], want[..., :128], rtol=0,
                               atol=1e-5)
    bits = np.unpackbits(p["desc_bits"], axis=-1, bitorder="big")
    np.testing.assert_array_equal(
        got[..., 128:], np.float32(eng.cfg.hybrid_alpha) * bits)


def _cfg(mod, out, host_desc, streaming):
    """tests/test_runtime.py's _cfg with Huber BA (every 4 frames here),
    host ingest at full resolution and the host descriptor."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12, ingest="host", ingest_downscale=1,
                        host_descriptor=host_desc, streaming=streaming)
    return mod.Config(usePhotosCycle=True, outputDataDir=str(out),
                      requiredExtractedPointsCount=80,
                      featureExtractingThreshold=20, framesBatchSize=6,
                      requiredMatchedPointsCount=30, knnMatcherDistance=0.8,
                      RPDistanceThreshold=500.0, useBundleAdjustment=True,
                      BAMaxFramesCnt=4, BAUseHuberLossFunction=True,
                      BAHuberLossFunctionParameter=2.0, tpu=tpu)


def _rel_ate(scene, gd):
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    return absolute_trajectory_error(est, gt) / np.linalg.norm(
        gt.max(0) - gt.min(0))


@pytest.mark.parametrize("host_desc", ["orb", "hybrid"])
@pytest.mark.parametrize("streaming", [True, False])
def test_engine_host_descriptor_modes_e2e(rt_scene, rt_frames, tmp_path,
                                          host_desc, streaming):
    """Twin of tests/test_runtime.py's test_engine_host_descriptor_modes_e2e
    on the streaming and the classic device loop: the port tracks the JAX
    package's camera schedule with "orb" (Hamming on the host's bits, no
    gray plane) and "hybrid" (pooled SIFT ⊕ α·bits, D=384), ATE under its
    8 % bound and within 0.02 of the extent of the JAX run's."""
    engines = []
    orig_init = DeviceEngine.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        engines.append(self)

    DeviceEngine.__init__ = init
    try:
        gd = tapp.slam_main(_cfg(tconfig, tmp_path / "t", host_desc,
                                 streaming),
                            rt_scene.K, frames=list(rt_frames), device="cpu")
    finally:
        DeviceEngine.__init__ = orig_init
    eng = engines[0]
    assert eng._will_stream == streaming
    assert (eng.cfg.host_desc, eng.cfg.metric, eng.cfg.desc_dim) == (
        (host_desc, "hamming", 8) if host_desc == "orb"
        else (host_desc, "l2", 384))
    gd_j = japp.slam_main(_cfg(jconfig, tmp_path / "j", host_desc,
                               streaming),
                          rt_scene.K, frames=list(rt_frames))
    assert len(gd.rotations) >= 10
    assert [int(f) for f in gd.frame_ids] == [int(f) for f in gd_j.frame_ids]
    rel_t, rel_j = _rel_ate(rt_scene, gd), _rel_ate(rt_scene, gd_j)
    assert rel_t < 0.08 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)


def test_hybrid_config_field_reaches_the_engine():
    """``tpu.hybrid_alpha`` and ``tpu.host_descriptor`` reach the engine
    configuration under the JAX package's names."""
    cfg = dataclasses.replace(
        tconfig.Config(), tpu=tconfig.TpuConfig(hybrid_alpha=0.15,
                                                host_descriptor="hybrid"))
    ecfg = EngineConfig.from_config(cfg)
    jcfg = JEngineConfig.from_config(dataclasses.replace(
        jconfig.Config(), tpu=jconfig.TpuConfig(hybrid_alpha=0.15,
                                                host_descriptor="hybrid")))
    assert (ecfg.hybrid_alpha, ecfg.host_desc) == (0.15, "hybrid")
    assert (ecfg.hybrid_alpha, ecfg.host_desc) == (jcfg.hybrid_alpha,
                                                   jcfg.host_desc)
