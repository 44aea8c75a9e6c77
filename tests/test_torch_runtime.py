"""The port's device-ingest runtime against the JAX package's, on the CPU:
one ``advance_window`` from a state carried across, and ``slam_main`` end
to end on the same frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io.media import ArraySource as JArraySource
from slam_indoor_code_tpu.runtime import DeviceEngine as JEngine
from slam_indoor_code_tpu.runtime import EngineConfig as JEngineConfig
from slam_indoor_code_tpu.runtime import steps as jsteps
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io.logs import load_global_data_from_logs
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.runtime import EngineConfig, state_from_numpy
from slam_indoor_code_tpu_torch.runtime import steps as tsteps
from slam_indoor_code_tpu_torch.runtime.engine import resolve_ingest

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rt_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


@pytest.fixture(scope="module")
def rt_frames(rt_scene):
    return [rt_scene.render(i) for i in range(14)]


def _cfg(mod, out, **over):
    """tests/test_runtime.py's _cfg with BA on (window 4), device ingest."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12, ingest="device")
    base = dict(usePhotosCycle=True, outputDataDir=str(out),
                requiredExtractedPointsCount=80, featureExtractingThreshold=20,
                framesBatchSize=6, requiredMatchedPointsCount=30,
                knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
                useBundleAdjustment=True, BAMaxFramesCnt=4,
                BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
                tpu=tpu)
    base.update(over)
    return mod.Config(**base)


def _rel_ate(scene, gd):
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    return absolute_trajectory_error(est, gt) / np.linalg.norm(
        gt.max(0) - gt.min(0))


@pytest.fixture(scope="module")
def both_runs(rt_scene, rt_frames, tmp_path_factory):
    out_j = tmp_path_factory.mktemp("jax")
    out_t = tmp_path_factory.mktemp("torch")
    gd_j = japp.slam_main(_cfg(jconfig, out_j), rt_scene.K, frames=rt_frames)
    gd_t = tapp.slam_main(_cfg(tconfig, out_t), rt_scene.K, frames=rt_frames,
                          device="cpu")
    return gd_j, gd_t, out_t


def test_slam_main_matches_jax_end_to_end(rt_scene, both_runs):
    """Same camera schedule; port ATE < 0.08 of the trajectory extent and
    within 0.02 of the JAX run's (RANSAC draws differ between the two
    generators, so the poses agree statistically, not bit for bit)."""
    gd_j, gd_t, _ = both_runs
    assert [int(f) for f in gd_t.frame_ids] == [int(f) for f in gd_j.frame_ids]
    assert len(gd_t.rotations) >= 10
    rel_t, rel_j = _rel_ate(rt_scene, gd_t), _rel_ate(rt_scene, gd_j)
    assert rel_t < 0.08, rel_t
    assert abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)
    assert abs(len(gd_t.points) - len(gd_j.points)) < 0.15 * len(gd_j.points)


def test_reference_format_outputs_reload(both_runs):
    _, gd_t, out = both_runs
    for name in ("poses", "rotations", "points", "colors", "main", "time"):
        assert (out / f"{name}.txt").exists(), name
    reloaded = load_global_data_from_logs(str(out))
    assert len(reloaded.rotations) == len(gd_t.rotations)
    assert len(reloaded.points) == len(gd_t.points)
    assert "Bundle Adjustment statistics" in (out / "main.txt").read_text()
    cfg = _cfg(tconfig, out, onlyViz=True)
    assert len(tapp.run_from_config(cfg).rotations) == len(gd_t.rotations)


def test_advance_window_from_carried_state(rt_scene, rt_frames):
    """A JAX engine bootstraps and fills; its TrackerState is carried
    across with ``state_from_numpy``; one advance_window in each package
    from that state scans the same frames: the same found / good_pos /
    count per step (the schedule depends on matching only)."""
    jcfg = JEngineConfig.from_config(_cfg(jconfig, "unused"))
    eng = JEngine(JArraySource(rt_frames), rt_scene.K, jcfg, batch_size=6,
                  required_extracted=80)
    assert eng._bootstrap(np.eye(3), np.zeros(3))
    eng.fill()
    B = eng.batch_size + max(eng.cfg.fill_chunk, eng.cfg.window)
    queue = np.zeros(B, np.int32)
    nq = min(len(eng.batch), B)
    queue[:nq] = eng.batch[:nq]
    fields = {k: np.asarray(v) for k, v in eng.state._asdict().items()}
    T = eng.cfg.window
    keys = jnp.stack(jax.random.split(jax.random.PRNGKey(1), T))
    _, jpacked, jqh, jql = jsteps.advance_window(
        eng.cfg, eng.state, jnp.asarray(queue), jnp.asarray(0, jnp.int32),
        jnp.asarray(nq, jnp.int32), jnp.asarray(eng._win_fill, jnp.int32),
        keys, T, visible=eng.batch_size)
    jpacked = np.asarray(jpacked)

    tcfg = EngineConfig(**dataclasses.asdict(eng.cfg))
    state = state_from_numpy(fields, "cpu")
    for name, t in state.tensors().items():
        assert tuple(t.shape) == fields[name].shape, name
        np.testing.assert_array_equal(
            t.numpy(), fields[name].view(np.int32) if fields[name].dtype ==
            np.uint32 else fields[name], err_msg=name)
    gen = torch.Generator().manual_seed(1)
    state, tpacked, tqh, tql = tsteps.advance_window(
        tcfg, state, torch.from_numpy(queue), 0, nq, eng._win_fill, gen, T,
        visible=eng.batch_size)
    tpacked = tpacked.numpy()
    active = jpacked[:, 0] > 0.5
    assert active.sum() >= 2
    np.testing.assert_array_equal(tpacked[:, 0] > 0.5, active)
    np.testing.assert_array_equal(tpacked[active, 1:4], jpacked[active, 1:4])
    np.testing.assert_array_equal(tpacked[active, 4], jpacked[active, 4])
    np.testing.assert_array_equal(tpacked[active, 21], jpacked[active, 21])
    assert (int(tqh), int(tql)) == (int(jqh), int(jql))
    assert all(t.device.type == "cpu" for t in state.tensors().values())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU error path needs a machine without CUDA")
    from slam_indoor_code_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.slam_main(_cfg(tconfig, "unused"), np.eye(3), frames=[])
    assert resolve_ingest("auto") == "device"
    with pytest.raises(NotImplementedError, match="host"):
        resolve_ingest("host")
