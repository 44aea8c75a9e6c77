"""The L1 matching path end to end on the CPU: ``slam_main`` of both
packages with ``EngineConfig.metric = "l1"`` (the reference CUDA backend's
NORM_L1 matcher) on tests/test_runtime.py's scene.  Both runs share one
module-scoped fixture, so one worker takes them."""

import dataclasses

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.runtime import EngineConfig as JEngineConfig
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.ops import knn as tknn
from slam_indoor_code_tpu_torch.runtime import EngineConfig

torch.set_num_threads(1)


def _cfg(mod, out):
    """tests/test_torch_runtime.py's configuration: BA on (window 4),
    device ingest, 512 keypoints."""
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
        tpu=tpu)


def _l1(cls):
    orig = cls.from_config
    return staticmethod(
        lambda cfg: dataclasses.replace(orig(cfg), metric="l1"))


def _rel_ate(scene, gd):
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    return absolute_trajectory_error(est, gt) / np.linalg.norm(
        gt.max(0) - gt.min(0))


@pytest.fixture(scope="module")
def l1_runs(tmp_path_factory):
    scene = make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)
    frames = [scene.render(i) for i in range(14)]
    metrics = []
    orig_match_batch = tknn.match_batch

    def spy_match_batch(*args, **kw):
        metrics.append(kw.get("metric", args[6] if len(args) > 6 else "l2"))
        return orig_match_batch(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEngineConfig, "from_config", _l1(JEngineConfig))
        mp.setattr(EngineConfig, "from_config", _l1(EngineConfig))
        mp.setattr(tknn, "match_batch", spy_match_batch)
        gd_j = japp.slam_main(_cfg(jconfig, tmp_path_factory.mktemp("jax")),
                              scene.K, frames=frames)
        gd_t = tapp.slam_main(_cfg(tconfig, tmp_path_factory.mktemp("torch")),
                              scene.K, frames=frames, device="cpu")
    return scene, gd_j, gd_t, metrics


def test_l1_port_matches_every_step_with_l1(l1_runs):
    *_, metrics = l1_runs
    assert len(metrics) >= 10
    assert set(metrics) == {"l1"}


def test_l1_slam_main_matches_jax_end_to_end(l1_runs):
    """Same camera schedule; port ATE < 0.08 of the trajectory extent and
    within 0.02 of the JAX run's (RANSAC draws differ between the two
    generators, so the poses agree statistically, not bit for bit)."""
    scene, gd_j, gd_t, _ = l1_runs
    assert [int(f) for f in gd_t.frame_ids] == [int(f) for f in gd_j.frame_ids]
    assert len(gd_t.rotations) >= 10
    rel_t, rel_j = _rel_ate(scene, gd_t), _rel_ate(scene, gd_j)
    assert rel_t < 0.08, rel_t
    assert abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)


def test_l1_map_size_matches_jax(l1_runs):
    _, gd_j, gd_t, _ = l1_runs
    assert len(gd_j.points) > 100
    assert abs(len(gd_t.points) - len(gd_j.points)) < 0.15 * len(gd_j.points)
    assert np.all(np.isfinite(gd_t.points))
