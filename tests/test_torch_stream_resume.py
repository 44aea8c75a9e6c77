"""Kill-and-resume through the port's streaming loop, on the CPU: a run
killed after periodic snapshots and resumed from the last one gives the
uninterrupted run's trajectory and map (tests/test_runtime.py's
test_streaming_kill_and_resume_identical_tail, held bit for bit here)."""

import dataclasses

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io.media import ArraySource
from slam_indoor_code_tpu_torch.runtime import checkpoint_next_fid

torch.set_num_threads(1)


class KilledSource(ArraySource):
    def __init__(self, frames, kill_after):
        super().__init__(frames)
        self._kill_after = kill_after

    def next_frame(self):
        if self._i >= self._kill_after:
            raise RuntimeError("simulated crash")
        return super().next_frame()


def _cfg(out, **tpu_over):
    """The JAX twin's configuration: host ingest ("same" descriptors), the
    streaming loop, Huber BA every 4 frames."""
    tpu = tconfig.TpuConfig(max_keypoints=512, ransac_iters=256,
                            pnp_ransac_iters=128, window_points=4096,
                            ba_max_iters=12, ingest="host",
                            ingest_downscale=1, host_descriptor="same",
                            streaming=True)
    return tconfig.Config(
        usePhotosCycle=True, outputDataDir=str(out),
        requiredExtractedPointsCount=80, featureExtractingThreshold=20,
        framesBatchSize=6, requiredMatchedPointsCount=30,
        knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
        useBundleAdjustment=True, BAMaxFramesCnt=4,
        BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
        tpu=dataclasses.replace(tpu, **tpu_over))


def test_streaming_kill_and_resume_identical_run(tmp_path):
    """The JAX twin's 64 frames (rt_scene's 14, repeated) and kill point:
    the streaming admission budget runs ~40 frames ahead of the processed
    consumption, so the kill lands late enough for snapshots to precede
    it.  Every snapshot drains the calls in flight, so the resumed run
    equals the uninterrupted one: the whole trajectory (the snapshot's
    flushed part re-emitted), the map and the poses file, bit for bit."""
    scene = make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)
    frames = [scene.render(i % 14) for i in range(64)]
    gd_a = tapp.slam_main(_cfg(tmp_path / "a"), scene.K, frames=list(frames),
                          device="cpu")
    ck = str(tmp_path / "run.npz")
    with pytest.raises(RuntimeError, match="simulated crash"):
        tapp.slam_main(_cfg(tmp_path / "b1", checkpoint_path=ck,
                            checkpoint_every=4), scene.K,
                       frames=KilledSource(list(frames), kill_after=56),
                       device="cpu")
    assert checkpoint_next_fid(ck) > 8
    assert "Checkpoint saved" in (tmp_path / "b1" / "main.txt").read_text()
    gd_b = tapp.slam_main(_cfg(tmp_path / "b2", resume_path=ck), scene.K,
                          frames=list(frames), device="cpu")
    assert "Resumed from" in (tmp_path / "b2" / "main.txt").read_text()
    assert len(gd_a.rotations) >= 40
    np.testing.assert_array_equal(gd_b.frame_ids, gd_a.frame_ids)
    np.testing.assert_array_equal(gd_b.rotations, gd_a.rotations)
    np.testing.assert_array_equal(gd_b.positions, gd_a.positions)
    np.testing.assert_array_equal(gd_b.points, gd_a.points)
    n_poses = len((tmp_path / "b2" / "poses.txt").read_text().splitlines())
    assert n_poses == len((tmp_path / "a" / "poses.txt").read_text()
                          .splitlines())
