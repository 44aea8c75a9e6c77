"""The port's ops (image, FAST, SIFT, 2-NN matching) against the JAX
package's on the same rendered frames, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.ops import fast as jfast
from slam_indoor_code_tpu.ops import image as jimage
from slam_indoor_code_tpu.ops import knn as jknn
from slam_indoor_code_tpu.ops import sift as jsift
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch.ops import fast, image, knn, sift

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    # the size of tests/test_runtime.py's rt_scene
    scene = make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)
    return [scene.render(i) for i in (0, 1, 2)]


@pytest.fixture(scope="module")
def gray(frames):
    return np.asarray(jimage.rgb_to_gray(jnp.asarray(frames[0])))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_image_primitives(frames, gray, rng):
    g = gray[:96, :128]
    np.testing.assert_allclose(
        image.rgb_to_gray(_t(frames[0])).numpy(), gray, rtol=1e-6, atol=1e-4)
    for sigma, radius in ((2.0, None), (1.6, 4), (0.6, 2)):
        np.testing.assert_allclose(
            image.gaussian_blur(_t(g), sigma, radius).numpy(),
            np.asarray(jimage.gaussian_blur(jnp.asarray(g), sigma, radius)),
            rtol=1e-5, atol=1e-3)
    for got, want in zip(image.sobel_gradients(_t(g)),
                         jimage.sobel_gradients(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    maps = rng.normal(size=(40, 50, 8)).astype(np.float32)
    xy = rng.uniform(-3, 55, size=(30, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        image.sample_maps(_t(maps), _t(xy)).numpy(),
        np.asarray(jimage.sample_maps(jnp.asarray(maps), jnp.asarray(xy))))
    np.testing.assert_allclose(
        image.sample_maps_bilinear(_t(maps), _t(xy)).numpy(),
        np.asarray(jimage.sample_maps_bilinear(jnp.asarray(maps),
                                               jnp.asarray(xy))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        image.extract_patch_colors(_t(frames[0]), _t(xy * 10)).numpy(),
        np.asarray(jimage.extract_patch_colors(jnp.asarray(frames[0]),
                                               jnp.asarray(xy * 10))))


def test_fast_detect_matches(gray):
    want = jfast.detect(jnp.asarray(gray), 20.0, 512)
    got = fast.detect(_t(gray), 20.0, 512)
    assert int(got["num_corners"]) == int(want["num_corners"])
    wv = np.asarray(want["valid"])
    gv = got["valid"].numpy()
    assert gv.sum() == wv.sum() > 100

    def keys(xy, score, v):
        xy, score = np.asarray(xy)[v], np.asarray(score)[v]
        o = np.lexsort((xy[:, 1], xy[:, 0], -score))
        return xy[o], score[o]

    wxy, ws = keys(want["xy"], want["score"], wv)
    gxy, gs = keys(got["xy"].numpy(), got["score"].numpy(), gv)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(gxy, wxy, atol=1e-4)
    # same slot order too (ties break toward the raster-first pixel)
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(want["xy"]),
                               atol=1e-4)


@pytest.mark.parametrize("downscale,nearest", [(1, "auto"), (2, "on")])
def test_sift_describe_matches(gray, downscale, nearest):
    det = jfast.detect(jnp.asarray(gray), 20.0, 512)
    xy, valid = np.asarray(det["xy"]), np.asarray(det["valid"])
    want = jsift.describe(jnp.asarray(gray), jnp.asarray(xy),
                          jnp.asarray(valid), downscale=downscale,
                          nearest=nearest)
    got = sift.describe(_t(gray), _t(xy), _t(valid), downscale=downscale,
                        nearest=nearest)
    np.testing.assert_allclose(got["angle"].numpy(), np.asarray(want["angle"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["desc"].numpy(), np.asarray(want["desc"]),
                               atol=1e-5)


def test_knn_match_batch_cpu_matches(frames):
    grays = [np.asarray(jimage.rgb_to_gray(jnp.asarray(f))) for f in frames]
    descs, valids = [], []
    for g in grays:
        det = jfast.detect(jnp.asarray(g), 20.0, 512)
        d = jsift.describe(jnp.asarray(g), det["xy"], det["valid"])
        descs.append(np.asarray(d["desc"]))
        valids.append(np.asarray(det["valid"]))
    prev_d, prev_v = descs[0], valids[0]
    bd, bv = np.stack(descs[1:] + descs[:1]), np.stack(valids[1:] + valids[:1])
    fmask = np.array([True, True, False])
    want = jknn.match_batch(jnp.asarray(prev_d), jnp.asarray(prev_v),
                            jnp.asarray(bd), jnp.asarray(bv),
                            jnp.asarray(fmask), ratio=0.8, metric="l2")
    got = knn.match_batch(_t(prev_d), _t(prev_v), _t(bd), _t(bv), _t(fmask),
                          ratio=0.8, metric="l2")
    np.testing.assert_array_equal(got["is_match"].numpy(),
                                  np.asarray(want["is_match"]))
    m = np.asarray(want["is_match"])
    np.testing.assert_array_equal(got["train_idx"].numpy()[m],
                                  np.asarray(want["train_idx"])[m])
    np.testing.assert_array_equal(got["num_matches"].numpy(),
                                  np.asarray(want["num_matches"]))
    assert m[0].sum() > 100


def test_knn_hamming_matches(rng):
    a = rng.integers(0, 2**32, (40, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (3, 60, 8), dtype=np.uint64).astype(np.uint32)
    vb = rng.random((3, 60)) > 0.1
    va = np.ones(40, bool)
    fm = np.ones(3, bool)
    want = jknn.match_batch(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                            jnp.asarray(vb), jnp.asarray(fm), ratio=0.9,
                            metric="hamming")
    got = knn.match_batch(_t(a.view(np.int32)), _t(va), _t(b.view(np.int32)),
                          _t(vb), _t(fm), ratio=0.9, metric="hamming")
    np.testing.assert_array_equal(got["train_idx"].numpy(),
                                  np.asarray(want["train_idx"]))
    np.testing.assert_array_equal(got["is_match"].numpy(),
                                  np.asarray(want["is_match"]))
