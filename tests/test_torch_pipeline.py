"""The port's classic host conductor (pipeline/, WindowedBA, the RGB
frontend entry points, slam_main with ``tpu.device_runtime=false``)
against the JAX package's, on the CPU at small size: the host structures
and the good-frame rule exactly, the frontend to tests/test_torch_ops.py's
tolerance, one windowed BA to atol 1e-4 / 1e-3, and twins of
tests/test_pipeline.py end to end (same camera count, ATE within 0.02 of
the JAX run's)."""

import copy
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io.media import ArraySource as JArraySource
from slam_indoor_code_tpu.models import frontend as jfe
from slam_indoor_code_tpu.pipeline import batch as jbatch
from slam_indoor_code_tpu.pipeline import structures as jst
from slam_indoor_code_tpu.solver.ba import WindowedBA as JWindowedBA
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io.media import ArraySource
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.models import frontend as tfe
from slam_indoor_code_tpu_torch.pipeline import batch as tbatch
from slam_indoor_code_tpu_torch.pipeline import structures as tst
from slam_indoor_code_tpu_torch.solver.ba import WindowedBA

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def e2e_scene():
    # tests/test_pipeline.py's e2e_scene
    return make_scene(n_points=700, n_frames=16, seed=5, baseline=0.3)


@pytest.fixture(scope="module")
def e2e_frames(e2e_scene):
    return [e2e_scene.render(i) for i in range(16)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ structures
def _arena_pair(rng, cap=300, n=120):
    pts = rng.normal(size=(n, 3))
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    out = []
    for mod in (jst, tst):
        a = mod.MapArena(cap)
        ids = a.append(pts, cols)
        out.append((a, ids))
    return out


def test_map_arena_equals_jax(rng):
    (ja, jids), (ta, tids) = _arena_pair(rng)
    np.testing.assert_array_equal(tids, jids)
    assert tids.dtype == jids.dtype and ta.count == ja.count
    for x, y in zip(ta.snapshot(), ja.snapshot()):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(RuntimeError, match="max_map_points"):
        ta.append(np.zeros((400, 3)), np.zeros((400, 3), np.uint8))
    fd_t, fd_j = tst.TemporalFrameData.empty(7, 4), jst.TemporalFrameData.empty(7, 4)
    for f in dataclasses.fields(fd_j):
        x, y = getattr(fd_t, f.name), getattr(fd_j, f.name)
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_pnp_harvest_and_push_equal_jax(rng):
    (ja, _), (ta, _) = _arena_pair(rng)
    K = 64
    prev_corr = np.where(rng.random(K) < 0.5, rng.integers(0, 120, K), -1
                         ).astype(np.int32)
    train = rng.permutation(K).astype(np.int32)
    mask = rng.random(K) < 0.7
    xy = rng.normal(size=(K, 2)).astype(np.float32) * 100
    for a, b in zip(tst.harvest_pnp_correspondences(prev_corr, train, mask,
                                                    xy, ta),
                    jst.harvest_pnp_correspondences(prev_corr, train, mask,
                                                    xy, ja)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    new_pts = rng.normal(size=(K, 3))
    new_cols = rng.integers(0, 256, (K, 3)).astype(np.uint8)
    new_ok, prop_ok = rng.random(K) < 0.8, rng.random(K) < 0.8
    got, want = [], []
    for mod, arena, res in ((tst, ta, got), (jst, ja, want)):
        pc, nc = prev_corr.copy(), np.full(K, -1, np.int32)
        n = mod.push_new_spatial_points(new_cols, new_pts, arena, pc, train,
                                        mask, nc, new_point_ok=new_ok,
                                        propagate_ok=prop_ok)
        res += [n, pc, nc, *arena.snapshot()]
    assert got[0] == want[0] > 0
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------- good-frame rule
@pytest.mark.parametrize("use_first_fit", [False, True])
@pytest.mark.parametrize("head_tie_tolerance", [0.0, 0.1])
@pytest.mark.parametrize("skip_from_head", [0, 2, 20])
def test_select_equals_jax(use_first_fit, head_tie_tolerance, skip_from_head):
    """BatchScheduler._select on many count vectors (ties, none eligible,
    skip past the end) gives the JAX scheduler's index exactly."""
    rng = np.random.default_rng(11)
    kw = dict(batch_size=16, required_extracted=10, required_matched=30,
              skip_from_head=skip_from_head, use_first_fit=use_first_fit,
              head_tie_tolerance=head_tie_tolerance)
    js = jbatch.BatchScheduler(None, jfe.FrontendConfig(), **kw)
    ts = tbatch.BatchScheduler(None, tfe.FrontendConfig(), device="cpu", **kw)
    found = 0
    for _ in range(200):
        B = int(rng.integers(1, 17))
        counts = rng.integers(0, 60, B)
        if rng.random() < 0.3:       # plant ties at the maximum
            counts[rng.integers(0, B, 2)] = counts.max()
        got, want = ts._select(counts), js._select(counts)
        assert got == want, (counts, got, want)
        found += want >= 0
    if skip_from_head < 16:
        assert found > 50


# ------------------------------------------------------------- frontend
@pytest.fixture(scope="module")
def both_extracts(e2e_frames):
    fcfg = dict(max_keypoints=512, threshold=20.0, ratio=0.8)
    rgb = np.stack([e2e_frames[i] for i in (0, 1, 3)])
    want = jfe.extract_and_describe_batch(jfe.FrontendConfig(**fcfg),
                                          jnp.asarray(rgb))
    got = tfe.extract_and_describe_batch(tfe.FrontendConfig(**fcfg), _t(rgb))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, fcfg)


def test_extract_and_describe_batch_equals_jax(both_extracts):
    """valid, num_corners and colours exactly; the subpixel xy and the
    corner scores to two float32 ulps (XLA fuses the float gray into the
    jitted detector, which rounds some scores, and with them a rare
    quadratic fit, one or two ulps apart; fed the same gray the two
    detectors agree bit for bit, tests/test_torch_ops.py); the
    descriptors to tests/test_torch_ops.py's atol 1e-5."""
    want, got, _ = both_extracts
    for k in ("valid", "num_corners", "colors"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("xy", "score"):
        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=2)
    assert want["valid"].sum(-1).min() > 100
    np.testing.assert_allclose(got["desc"], want["desc"], atol=1e-5)


def test_extract_and_describe_one_frame_and_detect_only(e2e_frames):
    fcfg = tfe.FrontendConfig(max_keypoints=256, threshold=20.0)
    jcfg = jfe.FrontendConfig(max_keypoints=256, threshold=20.0)
    one = tfe.extract_and_describe(fcfg, _t(e2e_frames[2]))
    want = jfe.extract_and_describe(jcfg, jnp.asarray(e2e_frames[2]))
    np.testing.assert_array_max_ulp(one["xy"].numpy(), np.asarray(want["xy"]),
                                    maxulp=2)
    assert int(one["num_corners"]) == int(want["num_corners"])
    det = tfe.detect_only_batch(fcfg, _t(np.stack(e2e_frames[:2])))
    jdet = jfe.detect_only_batch(jcfg, jnp.asarray(np.stack(e2e_frames[:2])))
    np.testing.assert_array_equal(det["num_corners"].numpy(),
                                  np.asarray(jdet["num_corners"]))
    np.testing.assert_array_max_ulp(det["xy"].numpy(), np.asarray(jdet["xy"]),
                                    maxulp=2)


def test_match_against_batch_on_jax_descriptors(both_extracts):
    """The JAX descriptors through both packages' match_against_batch: the
    same num_matches per candidate and the same chosen index."""
    want, _, fcfg = both_extracts
    prev_d, prev_v = want["desc"][0], want["valid"][0]
    bd, bv = want["desc"][1:], want["valid"][1:]
    fm = np.ones(len(bd), bool)
    jres = jfe.match_against_batch(jfe.FrontendConfig(**fcfg),
                                   jnp.asarray(prev_d), jnp.asarray(prev_v),
                                   jnp.asarray(bd), jnp.asarray(bv),
                                   jnp.asarray(fm))
    tres = tfe.match_against_batch(tfe.FrontendConfig(**fcfg), _t(prev_d),
                                   _t(prev_v), _t(bd), _t(bv), _t(fm))
    jn = np.asarray(jres["num_matches"])
    np.testing.assert_array_equal(tres["num_matches"].numpy(), jn)
    assert jn.min() > 30
    kw = dict(batch_size=16, required_extracted=10, required_matched=30)
    js = jbatch.BatchScheduler(None, jfe.FrontendConfig(), **kw)
    ts = tbatch.BatchScheduler(None, tfe.FrontendConfig(), device="cpu", **kw)
    good = js._select(jn)
    assert ts._select(tres["num_matches"].numpy()) == good >= 0
    m = np.asarray(jres["is_match"])[good]
    np.testing.assert_array_equal(tres["is_match"].numpy()[good], m)
    np.testing.assert_array_equal(tres["train_idx"].numpy()[good][m],
                                  np.asarray(jres["train_idx"])[good][m])


def test_classic_path_applies_undistortion(e2e_scene):
    """Twin of tests/test_pipeline.py's undistortion test: the port's
    scheduler corrects keypoints with DC at fill time, as the JAX one does,
    to float32 agreement with it."""
    dist = np.array([0.15, -0.05, 0.0, 0.0, 0.0])
    frames = [e2e_scene.render(0)]

    def xy_of(mod, fcfg, K, d, **kw):
        s = mod.BatchScheduler(
            (ArraySource if mod is tbatch else JArraySource)(list(frames)),
            fcfg, batch_size=1, required_extracted=10, required_matched=5,
            K=K, dist=d, **kw)
        s.fill()
        el = s.batch[0]
        return np.asarray(el.xy)[np.asarray(el.valid)]

    Kj = jnp.asarray(e2e_scene.K, jnp.float32)
    Kt = torch.tensor(e2e_scene.K, dtype=torch.float32)
    xy_off = xy_of(tbatch, tfe.FrontendConfig(max_keypoints=256), Kt, None,
                   device="cpu")
    xy_on = xy_of(tbatch, tfe.FrontendConfig(max_keypoints=256), Kt,
                  torch.tensor(dist, dtype=torch.float32), device="cpu")
    want = xy_of(jbatch, jfe.FrontendConfig(max_keypoints=256), Kj,
                 jnp.asarray(dist, jnp.float32))
    np.testing.assert_allclose(xy_on, want, atol=1e-3)
    c = np.array([e2e_scene.K[0, 2], e2e_scene.K[1, 2]])
    r_on = np.linalg.norm(xy_on - c, axis=1)
    r_off = np.linalg.norm(xy_off - c, axis=1)
    # barrel distortion: corrected points move outward from the centre
    assert (r_on < r_off - 1e-3).mean() > 0.8
    assert np.abs(r_on - r_off).max() > 1.0


# ------------------------------------------------------------ windowed BA
def test_windowed_ba_equals_jax():
    """One WindowedBA call on the same noisy 4-frame window and arena, with
    intrinsics adjusted and few LM iterations (so float32's stop rule
    cannot end one solve earlier than the other): K and poses to atol 1e-4,
    points to atol 1e-3, final RMSE to 1e-3 relative."""
    scene = make_scene(n_points=300, n_frames=4, seed=9, baseline=0.3)
    rng = np.random.default_rng(3)
    F, Kslots = 4, 320
    frames = []
    for f in range(F):
        uv, vis = scene.project(f, noise=0.5, rng=rng)
        fd = jst.TemporalFrameData.empty(Kslots, 1)
        ids = np.flatnonzero(vis)[:Kslots]
        fd.xy[: len(ids)] = uv[ids]
        fd.correspond[: len(ids)] = ids
        fd.valid[: len(ids)] = True
        fd.rotation = scene.rotations[f] @ _small_rot(rng, 0.01 * (f > 0))
        fd.motion = scene.translations[f] + 0.02 * (f > 0) * rng.normal(size=3)
        frames.append(fd)
    arena = jst.MapArena(400)
    arena.append(scene.points + rng.normal(0, 0.03, scene.points.shape),
                 scene.colors)
    K = scene.K.astype(np.float64) * np.array([[1.01, 1, 1.005],
                                               [1, 0.99, 0.995], [1, 1, 1]])
    out = {}
    for name, cls, kw in (("jax", JWindowedBA, {}),
                          ("torch", WindowedBA, {"device": "cpu"})):
        fr, ar, rep = copy.deepcopy(frames), copy.deepcopy(arena), io.StringIO()
        ba = cls(loss="huber", loss_param=2.0, max_iters=3, window=F,
                 window_points=512, report=rep, adjust_intrinsics=True, **kw)
        K_new = ba(K.copy(), fr, ar)
        rmse = [float(ln.split(":")[1]) for ln in rep.getvalue().splitlines()
                if ln.startswith((" Initial RMSE", " Final RMSE"))]
        out[name] = (K_new, fr, ar, rmse)
    Kj, frj, arj, rj = out["jax"]
    Kt, frt, art, rt = out["torch"]
    assert not np.allclose(Kj, K)          # the solve moved K
    np.testing.assert_allclose(Kt, Kj, atol=1e-4 * np.abs(Kj).max())
    for a, b in zip(frt, frj):
        np.testing.assert_allclose(a.rotation, b.rotation, atol=1e-4)
        np.testing.assert_allclose(a.motion, b.motion, atol=1e-4)
    np.testing.assert_allclose(art.points, arj.points, atol=1e-3)
    np.testing.assert_allclose(rt[0], rj[0], rtol=1e-3)
    np.testing.assert_allclose(rt[1], rj[1], rtol=1e-3)
    assert rj[1] < rj[0]


def _small_rot(rng, angle):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(size=3) * angle).as_matrix()


# ------------------------------------------------------------ end to end
def _cfg(mod, out, **over):
    """tests/test_pipeline.py's _cfg on the classic conductor."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12, device_runtime=False)
    base = dict(usePhotosCycle=True, outputDataDir=str(out),
                requiredExtractedPointsCount=80, featureExtractingThreshold=20,
                framesBatchSize=6, requiredMatchedPointsCount=30,
                knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
                useBundleAdjustment=False, tpu=tpu)
    base.update(over)
    return mod.Config(**base)


def _rel_ate(scene, gd):
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[: len(est)]
    return absolute_trajectory_error(est, gt) / np.linalg.norm(
        gt.max(0) - gt.min(0))


_BA = dict(useBundleAdjustment=True, BAMaxFramesCnt=6,
           BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0)


@pytest.mark.parametrize("case", ["ba_off", "ba_on", "track_loss"])
def test_classic_slam_main_twin(e2e_scene, e2e_frames, tmp_path, case):
    """Twins of tests/test_pipeline.py end to end through the classic
    conductor: the port's camera count equals the JAX run's on the same
    frames, its ATE is within 0.02 of the extent of the JAX run's, the map
    is not empty and main.txt carries the conductor's lines."""
    frames = list(e2e_frames)
    over = _BA if case == "ba_on" else {}
    if case == "track_loss":
        # black frames mid-sequence: the corner gate skips them or the
        # cycle restarts with the pose carried over
        black = [np.zeros_like(frames[0]) for _ in range(3)]
        frames = frames[:8] + black + frames[8:]
    gd_j = japp.slam_main(_cfg(jconfig, tmp_path / "jax", **over),
                          e2e_scene.K, frames=frames)
    gd_t = tapp.slam_main(_cfg(tconfig, tmp_path / "torch", **over),
                          e2e_scene.K, frames=frames, device="cpu")
    assert len(gd_t.rotations) == len(gd_j.rotations) >= 10
    rel_t, rel_j = _rel_ate(e2e_scene, gd_t), _rel_ate(e2e_scene, gd_j)
    assert rel_t < 0.05 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)
    assert len(gd_t.points) > 200
    main = (tmp_path / "torch" / "main.txt").read_text()
    assert "Batch size" in main and "Used in solvePnP" in main
    if case == "ba_on":
        assert "Bundle Adjustment statistics" in main


def test_engine_matches_classic_ba_off(tmp_path):
    """Twin of tests/test_runtime.py's test_engine_matches_classic_ba_off on
    the port: with map re-binding off (the engine's one deliberate
    departure from the classic conductor) the device runtime and the
    classic conductor track the same number of frames of rt_scene, the
    engine under 6 % ATE and within 0.03 of the extent of the classic
    run's, and maps within 15 % of each other in size."""
    scene = make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)
    frames = [scene.render(i) for i in range(14)]
    out = {}
    for name, device_runtime in (("classic", False), ("engine", True)):
        cfg = _cfg(tconfig, tmp_path / name)
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, device_runtime=device_runtime, rebind_cap=0))
        gd = tapp.slam_main(cfg, scene.K, frames=list(frames), device="cpu")
        out[name] = (gd, _rel_ate(scene, gd))
    (gd_c, rel_c), (gd_e, rel_e) = out["classic"], out["engine"]
    assert len(gd_e.rotations) == len(gd_c.rotations)
    assert rel_e < 0.06, f"engine ATE {rel_e:.3f}"
    assert abs(rel_e - rel_c) < 0.03, (rel_e, rel_c)
    assert abs(len(gd_e.points) - len(gd_c.points)) < 0.15 * len(gd_c.points)
