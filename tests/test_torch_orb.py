"""The port's ORB descriptors and the ORB/Hamming path against the JAX
package's, on the CPU: the BRIEF pattern and the bit packing exactly, the
image primitives ORB uses, ``describe`` on a rendered frame, matching
across two views, and ``slam_main`` with only ``useFM-ORB`` set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.ops import fast as jfast
from slam_indoor_code_tpu.ops import image as jimage
from slam_indoor_code_tpu.ops import orb as jorb
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.models import frontend as tfe
from slam_indoor_code_tpu_torch.ops import fast, image, knn, orb
from slam_indoor_code_tpu_torch.runtime import EngineConfig

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def rt_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


@pytest.fixture(scope="module")
def gray(rt_scene):
    return np.asarray(jimage.rgb_to_gray(jnp.asarray(rt_scene.render(0))))


def test_brief_pattern_equals_jax():
    np.testing.assert_array_equal(orb._brief_pattern(), jorb._brief_pattern())
    np.testing.assert_array_equal(orb._PATTERN, jorb._PATTERN)
    assert orb._PATTERN.dtype == np.float32


def test_pack_bits_equals_jax(rng):
    """Exact: the port's int32 words are the JAX uint32 words' int32 view,
    bit 31 included (all-ones words are -1)."""
    bits = rng.random((64, 256)) < 0.5
    bits[0] = True
    bits[1:3] = False
    bits[2, 31::32] = True
    want = np.asarray(jorb.pack_bits(jnp.asarray(bits))).view(np.int32)
    got = orb.pack_bits(_t(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == -1).all() and (got[1] == 0).all()
    assert (got[2] == np.int32(-2 ** 31)).all()


def test_separable_conv_and_nearest_sample_equal_jax(gray, rng):
    """Elementwise to 1e-5 (relative to the map's scale: the moment maps
    sum 31×31 pixels); nearest sampling exactly, rounding ties to even in
    both packages."""
    g = gray[:120, :160]
    for kx, ky in ((orb._RAMP, orb._ONES), (orb._ONES, orb._RAMP),
                   (np.array([0.25, 0.5, 0.25], np.float32),
                    np.array([1.0, -2.0, 1.0], np.float32))):
        want = np.asarray(jimage.separable_conv(jnp.asarray(g),
                                                jnp.asarray(kx),
                                                jnp.asarray(ky)))
        got = image.separable_conv(_t(g), kx, ky).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    xy = rng.uniform(-4, 170, size=(50, 3, 2)).astype(np.float32)
    xy[0, 0] = (2.5, 3.5)       # ties: 2.5 → 2, 3.5 → 4 in both
    xy[0, 1] = (-0.5, 0.5)
    got = image.nearest_sample(_t(g), _t(xy)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jimage.nearest_sample(jnp.asarray(g),
                                              jnp.asarray(xy))))
    assert got[0, 0] == g[4, 2] and got[0, 1] == g[0, 0]


def test_describe_equals_jax(gray):
    """On a rendered frame's FAST keypoints: angles within 1e-4 rad and at
    least 99.5 % of the descriptor bits equal.  The two packages round a
    rotated pattern point independently (cos/sin and atan2 may differ in the
    last ulp), so a point that lands on a rounding tie may sample the
    neighbouring pixel and flip its bit; that is all the 0.5 % allows."""
    det = jfast.detect(jnp.asarray(gray), 20.0, 512)
    xy = np.asarray(det["xy"])
    valid = np.asarray(det["valid"])
    assert valid.sum() > 200
    want = jorb.describe(jnp.asarray(gray), det["xy"], det["valid"])
    got = orb.describe(_t(gray), _t(xy), _t(valid))
    assert got["desc"].dtype == torch.int32
    assert tuple(got["desc"].shape) == (512, 8)
    ang = got["angle"].numpy()
    d_ang = np.abs(np.angle(np.exp(1j * (ang - np.asarray(want["angle"])))))
    assert d_ang[valid].max() < 1e-4, d_ang[valid].max()
    jd = np.asarray(want["desc"]).view(np.int32)
    td = got["desc"].numpy()
    assert (td[~valid] == 0).all()
    jb = np.unpackbits(jd[valid].view(np.uint8), bitorder="little")
    tb = np.unpackbits(td[valid].view(np.uint8), bitorder="little")
    assert (jb == tb).mean() >= 0.995, (jb == tb).mean()
    # describe_batch stacks describe per frame
    gb = orb.describe_batch(_t(gray)[None], _t(xy)[None], _t(valid)[None])
    np.testing.assert_array_equal(gb["desc"][0].numpy(), td)


def test_orb_matching_across_views(scene):
    """tests/test_ops.py::test_descriptor_matching_across_views with the
    port's FAST, ORB and Hamming ``match_pair``: > 50 matches, > 80 % of them
    near a landmark in both views and > 90 % of those on the same one."""
    def detect_describe(i):
        g = image.rgb_to_gray(_t(scene.render(i)))
        det = fast.detect(g, 20.0, 512)
        return det, orb.describe(g, det["xy"], det["valid"])

    det0, d0 = detect_describe(0)
    det1, d1 = detect_describe(1)
    m = knn.match_pair(d0["desc"], d0["valid"], d1["desc"], d1["valid"],
                       ratio=0.8, metric="hamming")
    n = int(m["num_matches"])
    assert n > 50, f"orb: only {n} matches"
    uv0, _ = scene.project(0)
    uv1, _ = scene.project(1)
    xy0, xy1 = det0["xy"].numpy(), det1["xy"].numpy()
    is_m, tr = m["is_match"].numpy(), m["train_idx"].numpy()

    def nearest_lm(xy, uv):
        d = np.linalg.norm(xy[:, None] - uv[None], axis=-1)
        return d.argmin(1), d.min(1)

    lm0, e0 = nearest_lm(xy0, uv0)
    lm1, e1 = nearest_lm(xy1, uv1)
    qi = np.flatnonzero(is_m)
    near = (e0[qi] < 6) & (e1[tr[qi]] < 6)
    agree = lm0[qi] == lm1[tr[qi]]
    assert near.mean() > 0.8
    assert agree[near].mean() > 0.9, agree[near].mean()


def _cfg(mod, out):
    """tests/test_torch_runtime.py's configuration with only useFM-ORB set:
    ORB descriptors, Hamming 2-NN, BA on (window 4), device ingest."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12, ingest="device")
    return mod.Config(
        usePhotosCycle=True, outputDataDir=str(out),
        requiredExtractedPointsCount=80, featureExtractingThreshold=20,
        framesBatchSize=6, requiredMatchedPointsCount=30,
        knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
        useBundleAdjustment=True, BAMaxFramesCnt=4,
        BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
        useFM_SIFT_BF=False, useFM_SIFT_FLANN=False, useFM_ORB=True,
        tpu=tpu)


def _rel_ate(scene, gd):
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    return absolute_trajectory_error(est, gt) / np.linalg.norm(
        gt.max(0) - gt.min(0))


@pytest.fixture(scope="module")
def orb_runs(rt_scene, tmp_path_factory):
    frames = [rt_scene.render(i) for i in range(14)]
    metrics, dtypes = [], []
    orig = knn.match_batch

    def spy(desc_prev, *args, **kw):
        metrics.append(kw.get("metric"))
        dtypes.append(desc_prev.dtype)
        return orig(desc_prev, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn, "match_batch", spy)
        gd_j = japp.slam_main(_cfg(jconfig, tmp_path_factory.mktemp("jax")),
                              rt_scene.K, frames=frames)
        gd_t = tapp.slam_main(_cfg(tconfig, tmp_path_factory.mktemp("torch")),
                              rt_scene.K, frames=frames, device="cpu")
    return gd_j, gd_t, metrics, dtypes


def test_orb_config_selects_hamming():
    ecfg = EngineConfig.from_config(_cfg(tconfig, "unused"))
    assert (ecfg.descriptor, ecfg.metric) == ("orb", "hamming")
    assert (ecfg.desc_dim, ecfg.desc_dtype) == (8, torch.int32)
    fcfg = tfe.frontend_config_from(_cfg(tconfig, "unused"))
    assert fcfg.descriptor == "orb"


def test_orb_slam_main_matches_jax_end_to_end(rt_scene, orb_runs):
    """Same camera schedule; port ATE < 0.08 of the extent and within 0.02
    of the JAX run's (RANSAC draws differ between the two generators)."""
    gd_j, gd_t, metrics, dtypes = orb_runs
    assert len(metrics) >= 10 and set(metrics) == {"hamming"}
    assert set(dtypes) == {torch.int32}
    assert [int(f) for f in gd_t.frame_ids] == [int(f) for f in gd_j.frame_ids]
    assert len(gd_t.rotations) >= 10
    rel_t, rel_j = _rel_ate(rt_scene, gd_t), _rel_ate(rt_scene, gd_j)
    assert rel_t < 0.08, rel_t
    assert abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)
    assert abs(len(gd_t.points) - len(gd_j.points)) < 0.15 * len(gd_j.points)
    assert np.all(np.isfinite(gd_t.points))


def test_hamming_rebind_gate_is_a_row_popcount(rng):
    """The re-binding's absolute gate in ``_track_core`` takes, per row, the
    Hamming distance of a feature to its propagated landmark: the JAX
    code's popcount of the xor, summed over the 8 words."""
    from slam_indoor_code_tpu_torch.runtime.steps import _row_hamming

    a = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32)
    b[0] = a[0]
    b[1] = ~a[1]
    want = np.unpackbits((a ^ b).view(np.uint8), axis=1).sum(1)
    got = _row_hamming(_t(a.view(np.int32)), _t(b.view(np.int32)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert got[0] == 0 and got[1] == 256
