"""Per-frame telemetry and ``tpu.profile_dir`` in the port, on the CPU: a
twin of tests/test_runtime.py's per_frame_telemetry test against the JAX
package's run, the one-step loop against the fused one, and the
torch.profiler trace of the device runtime (the classic conductor ignores
``profile_dir``, as the JAX package's does)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.runtime import DeviceEngine, steps

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rt_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


@pytest.fixture(scope="module")
def rt_frames(rt_scene):
    return [rt_scene.render(i) for i in range(14)]


def _cfg(mod, out, **tpu_over):
    """tests/test_runtime.py's per_frame_telemetry configuration: host
    ingest at full resolution, Huber BA every 4 frames, the JAX default
    host descriptor ("auto", which is "hybrid" here)."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12, ingest="host", ingest_downscale=1,
                        per_frame_telemetry=True)
    tpu = dataclasses.replace(tpu, **tpu_over)
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


def _matching_lines(out):
    return [ln for ln in (out / "time.txt").read_text().splitlines()
            if ln.startswith("Matching time for index")]


@pytest.fixture(scope="module", params=["auto", "same"])
def telemetry_run(request, rt_scene, rt_frames, tmp_path_factory):
    """The port's per-frame telemetry run with the default host descriptor
    ("hybrid") and with "same", with every advance_window call's step count
    and the engine recorded → (GlobalData, its output directory, the step
    counts, the engine, the host descriptor asked for)."""
    hd = request.param
    out = tmp_path_factory.mktemp(f"telemetry_{hd}")
    t_steps, engines = [], []
    orig_adv, orig_init = steps.advance_window, DeviceEngine.__init__

    def adv(*a, **kw):
        t_steps.append(a[7] if len(a) > 7 else kw["t_steps"])
        return orig_adv(*a, **kw)

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        engines.append(self)

    steps.advance_window, DeviceEngine.__init__ = adv, init
    try:
        gd = tapp.slam_main(_cfg(tconfig, out, host_descriptor=hd),
                            rt_scene.K, frames=list(rt_frames), device="cpu")
    finally:
        steps.advance_window, DeviceEngine.__init__ = orig_adv, orig_init
    return gd, out, t_steps, engines[0], hd


def test_per_frame_telemetry_mode(rt_scene, rt_frames, telemetry_run,
                                  tmp_path):
    """Twin of tests/test_runtime.py's per_frame_telemetry test: one step
    per dispatch, one "Matching time for index N" line per tracked step,
    and the JAX package's run on the same frames: the same cameras, ATE
    within 0.02 of the extent of its ATE."""
    gd, out, t_steps, engine, hd = telemetry_run
    assert len(gd.rotations) >= 10
    assert not engine._will_stream
    assert engine.cfg.host_desc == {"auto": "hybrid"}.get(hd, hd)
    assert t_steps and set(t_steps) == {1}
    lines = _matching_lines(out)
    assert len(lines) >= len(gd.rotations) - 2
    gd_j = japp.slam_main(_cfg(jconfig, tmp_path, host_descriptor=hd),
                          rt_scene.K, frames=list(rt_frames))
    assert [int(f) for f in gd.frame_ids] == [int(f) for f in gd_j.frame_ids]
    rel_t, rel_j = _rel_ate(rt_scene, gd), _rel_ate(rt_scene, gd_j)
    assert rel_t < 0.05 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)


def test_per_frame_telemetry_equals_fused_loop(rt_scene, rt_frames,
                                               telemetry_run, tmp_path):
    """The one-step loop schedules and tracks as the fused window loop
    does (the same scheduling rule at a finer dispatch granularity): the
    same cameras and chosen indices, poses to 1e-5."""
    gd, out, _, _, hd = telemetry_run
    fused = tapp.slam_main(
        _cfg(tconfig, tmp_path, per_frame_telemetry=False, streaming=False,
             host_descriptor=hd),
        rt_scene.K, frames=list(rt_frames), device="cpu")
    assert [int(f) for f in fused.frame_ids] == [int(f) for f in gd.frame_ids]
    idx = [ln.split()[4] for ln in _matching_lines(out)]
    assert [ln.split()[4] for ln in _matching_lines(tmp_path)] == idx
    np.testing.assert_allclose(fused.rotations, gd.rotations, atol=1e-5)
    np.testing.assert_allclose(fused.positions, gd.positions, atol=1e-5)


def test_profile_dir_writes_a_trace(rt_scene, rt_frames, tmp_path):
    """``tpu.profile_dir`` on the device runtime: a Chrome-trace JSON in
    the directory whose events name the step spans, and main.txt says
    where it went."""
    prof = tmp_path / "prof"
    cfg = _cfg(tconfig, tmp_path / "out", per_frame_telemetry=False,
               streaming=False, profile_dir=str(prof))
    gd = tapp.slam_main(cfg, rt_scene.K, frames=list(rt_frames)[:8],
                        device="cpu")
    assert len(gd.rotations) >= 6
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    names = {ev.get("name") for ev in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert "steps.advance_window" in names
    assert f"Profiling device trace to {prof}" in (
        tmp_path / "out" / "main.txt").read_text()


def test_classic_conductor_ignores_profile_dir(rt_scene, rt_frames,
                                               tmp_path):
    prof = tmp_path / "prof"
    cfg = _cfg(tconfig, tmp_path / "out", per_frame_telemetry=False,
               profile_dir=str(prof), device_runtime=False)
    gd = tapp.slam_main(cfg, rt_scene.K, frames=list(rt_frames)[:8],
                        device="cpu")
    assert len(gd.rotations) >= 6
    assert not prof.exists()
    assert "Profiling" not in (tmp_path / "out" / "main.txt").read_text()
