"""The port's final global BA (matrix-free LM-PCG) against the JAX
package's, on the CPU: the drifted problems of tests/test_ba.py solved by
both from the same numpy inputs, and the 64-frame drift bound of
tests/test_runtime.py through the port's ``slam_main``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.solver import global_ba as jgba
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.geometry.rotations import (
    matrix_to_rodrigues, rodrigues_to_matrix)
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.solver import global_ba as tgba

torch.set_num_threads(1)


def _aa(R):
    return matrix_to_rodrigues(torch.from_numpy(np.asarray(R, np.float64)))\
        .numpy()


def _centers(c6):
    R = rodrigues_to_matrix(torch.from_numpy(np.asarray(c6[:, :3],
                                                        np.float64))).numpy()
    return -np.einsum("nji,nj->ni", R, np.asarray(c6[:, 3:], np.float64))


def _pad(uv_l, ci_l, pi_l, bucket):
    uv = np.concatenate(uv_l).astype(np.float32)
    ci = np.concatenate(ci_l).astype(np.int32)
    pi = np.concatenate(pi_l).astype(np.int32)
    O = len(uv)
    pad = -(-O // bucket) * bucket - O
    return (np.concatenate([uv, np.zeros((pad, 2), np.float32)]),
            np.concatenate([ci, np.zeros(pad, np.int32)]),
            np.concatenate([pi, np.zeros(pad, np.int32)]),
            np.concatenate([np.ones(O, bool), np.zeros(pad, bool)]))


def drifted_problem():
    """tests/test_ba.py::test_global_ba_recovers_drifted_trajectory's
    problem: 24 cameras with simulated accumulated drift, 800 points."""
    N, P = 24, 800
    sc = make_scene(n_points=P, n_frames=N, seed=3, baseline=0.3,
                    kind="hallway")
    rng = np.random.default_rng(0)
    uv_l, ci_l, pi_l = [], [], []
    for f in range(N):
        uvf, vis = sc.project(f, noise=0.4, rng=rng)
        ids = np.flatnonzero(vis)[:400]
        uv_l.append(uvf[ids])
        ci_l.append(np.full(len(ids), f, np.int32))
        pi_l.append(ids.astype(np.int32))
    obs = _pad(uv_l, ci_l, pi_l, 1024)
    cams = np.zeros((N, 6), np.float32)
    for f in range(N):
        drift = 0.03 * f / N
        cams[f, :3] = _aa(sc.rotations[f]) + rng.normal(0, drift, 3)
        cams[f, 3:] = sc.translations[f] * (1 + drift) + rng.normal(0, drift,
                                                                    3)
    pts = sc.points.astype(np.float32) + rng.normal(
        0, 0.05, (P, 3)).astype(np.float32)
    return sc, cams, pts, obs, dict(max_iters=20, cg_iters=24)


def windowed_graph_problem():
    """tests/test_ba.py::test_global_ba_128_cameras_windowed_graph's
    problem: 128 cameras under a smooth drift field, short-window tracks
    plus a 5 % long-lived fraction."""
    N, P = 128, 3000
    sc = make_scene(n_points=P, n_frames=N, seed=11, baseline=0.25,
                    image_size=(480, 640), kind="hallway")
    rng = np.random.default_rng(1)
    long_lived = rng.random(P) < 0.05
    scale_f = 1.0 + np.cumsum(rng.normal(0.0006, 0.0004, N))
    trans_f = np.cumsum(rng.normal(0, 0.004, (N, 3)), axis=0)
    uv_l, ci_l, pi_l = [], [], []
    first_seen = np.full(P, -1)
    for f in range(N):
        uvf, vis = sc.project(f, noise=0.4, rng=rng)
        ids = np.flatnonzero(vis)
        new = first_seen[ids] < 0
        first_seen[ids[new]] = f
        keep = (f - first_seen[ids] < 12) | long_lived[ids]
        ids = ids[keep][:400]
        uv_l.append(uvf[ids])
        ci_l.append(np.full(len(ids), f, np.int32))
        pi_l.append(ids.astype(np.int32))
    obs = _pad(uv_l, ci_l, pi_l, 4096)
    cams = np.zeros((N, 6), np.float32)
    for f in range(N):
        C = -sc.rotations[f].T @ sc.translations[f]
        Cd = scale_f[f] * C + trans_f[f]
        cams[f, :3] = _aa(sc.rotations[f])
        cams[f, 3:] = -sc.rotations[f] @ Cd
    fs = np.clip(first_seen, 0, N - 1)
    pts = (sc.points * scale_f[fs][:, None] + trans_f[fs]).astype(np.float32)
    return sc, cams, pts, obs, dict(max_iters=25, cg_iters=24)


def _solve_both(problem):
    sc, cams, pts, obs, kw = problem
    K4 = np.array([sc.K[0, 0], sc.K[1, 1], sc.K[0, 2], sc.K[1, 2]],
                  np.float32)
    jc, jp, ji = jgba.global_bundle_adjust(
        jgba.GlobalBAConfig(**kw), jnp.asarray(K4), jnp.asarray(cams),
        jnp.asarray(pts), *(jnp.asarray(x) for x in obs))
    tc, tp, ti = tgba.global_bundle_adjust(
        tgba.GlobalBAConfig(**kw), torch.from_numpy(K4),
        torch.from_numpy(cams), torch.from_numpy(pts),
        *(torch.from_numpy(x) for x in obs))
    jinfo = {k: float(np.asarray(v)) for k, v in ji.items()}
    tinfo = {k: float(v) for k, v in ti.items()}
    return (np.asarray(jc), np.asarray(jp), jinfo, tc.numpy(), tp.numpy(),
            tinfo)


@pytest.mark.parametrize("make", [drifted_problem, windowed_graph_problem],
                         ids=["drifted_24", "windowed_graph_128"])
def test_global_bundle_adjust_matches_jax(make):
    """From the same inputs: camera 0 exactly fixed, every camera within
    1e-3 of the JAX solve, the same residual count, the final RMSE within
    1 % of the JAX one, and the refined trajectory at least as close to the
    ground truth as tests/test_ba.py asks of the JAX solver."""
    problem = make()
    sc, cams, *_ = problem
    jc, jp, ji, tc, tp, ti = _solve_both(problem)
    np.testing.assert_array_equal(tc[0], cams[0])
    np.testing.assert_allclose(tc, jc, atol=1e-3, rtol=0)
    assert ti["num_residuals"] == ji["num_residuals"]
    assert ti["initial_rmse"] == pytest.approx(ji["initial_rmse"], rel=1e-5)
    assert ti["final_rmse"] == pytest.approx(ji["final_rmse"], rel=0.01)
    assert ti["final_rmse"] <= ti["initial_rmse"]
    assert np.all(np.isfinite(tp))
    gt = sc.centers()
    ext = np.linalg.norm(gt.max(0) - gt.min(0))
    a0 = absolute_trajectory_error(_centers(cams), gt) / ext
    a1 = absolute_trajectory_error(_centers(tc), gt) / ext
    if make is drifted_problem:
        assert a1 < 0.01 and a1 < 0.35 * a0, (a0, a1)
        assert ti["final_rmse"] < 1.0
    else:
        assert a0 > 0.004 and a1 < 0.25 * a0, (a0, a1)


def _cfg(out, global_ba):
    """tests/test_runtime.py::test_global_ba_bounds_long_run_drift's
    configuration, device ingest pinned."""
    tpu = tconfig.TpuConfig(max_keypoints=768, ransac_iters=256,
                            pnp_ransac_iters=128, window_points=4096,
                            ba_max_iters=12, ingest="device",
                            global_ba=global_ba)
    return tconfig.Config(
        usePhotosCycle=True, outputDataDir=str(out),
        requiredExtractedPointsCount=60, featureExtractingThreshold=20,
        framesBatchSize=12, requiredMatchedPointsCount=25,
        knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
        useBundleAdjustment=True, BAMaxFramesCnt=8,
        BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
        tpu=tpu)


def test_global_ba_bounds_long_run_drift(tmp_path_factory):
    """tests/test_runtime.py::test_global_ba_bounds_long_run_drift on the
    port: 64 frames; with the final global BA the port must track ≥ 48
    cameras at ATE < 5 % of the extent and must not do worse than its
    windowed-only run (the same 2 % materiality margin as the JAX test)."""
    scene = make_scene(n_points=1200, n_frames=64, seed=7, baseline=0.25,
                       image_size=(240, 320), kind="hallway")
    frames = [scene.render(i) for i in range(64)]

    def run(global_ba):
        out = tmp_path_factory.mktemp(f"gba{int(global_ba)}")
        gd = tapp.slam_main(_cfg(out, global_ba), scene.K,
                            frames=list(frames), device="cpu")
        est = camera_centers(gd.rotations, gd.positions)
        gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
        ext = np.linalg.norm(gt.max(0) - gt.min(0))
        return (len(est), absolute_trajectory_error(est, gt) / ext, gd,
                (out / "main.txt").read_text())

    n_off, rel_off, gd_off, _ = run(False)
    n_on, rel_on, gd_on, log = run(True)
    assert "Global Bundle Adjustment statistics" in log
    assert n_on >= 48
    assert rel_on < 0.05, (rel_on, rel_off)
    assert rel_on <= rel_off * 1.02 + 1e-5, (rel_on, rel_off)
    assert list(gd_on.frame_ids) == list(gd_off.frame_ids)
    assert len(gd_on.points) == len(gd_off.points)
    assert np.all(np.isfinite(gd_on.points))


def test_global_ba_config_defaults_match_jax():
    assert dataclasses.asdict(tgba.GlobalBAConfig()) == dataclasses.asdict(
        jgba.GlobalBAConfig())
