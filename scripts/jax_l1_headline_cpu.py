"""The JAX package's device-ingest engine on the CPU with L1 matching, on
the frames and configuration that chip_smoke.py drives the port's L1 path
with: the bench.py headline (FHD, SIFT, ratio 0.8, 2048 keypoints, batch 16,
Huber BA every 8 frames) over the seed-7 synthetic hallway.  It gives the
reference level the port's L1 path on the card is held against.

    JAX_PLATFORMS=cpu python scripts/jax_l1_headline_cpu.py

Prints one line: cameras, ATE as a share of the trajectory extent, map
points and wall seconds.  Memory: a few GB at 32 FHD frames.
"""

import dataclasses
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("SLAM_TPU_NO_COMPILE_CACHE", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from slam_indoor_code_tpu import app  # noqa: E402
from slam_indoor_code_tpu.config import Config, TpuConfig  # noqa: E402
from slam_indoor_code_tpu.metrics import absolute_trajectory_error  # noqa: E402
from slam_indoor_code_tpu.metrics.ate import camera_centers  # noqa: E402
from slam_indoor_code_tpu.runtime import EngineConfig  # noqa: E402
from slam_indoor_code_tpu.testing import make_scene  # noqa: E402


def main() -> None:
    n_frames = 32
    scene = make_scene(n_points=1500, n_frames=n_frames,
                       image_size=(1080, 1920), seed=7, baseline=0.25,
                       kind="hallway")
    frames = [scene.render(i) for i in range(n_frames)]
    orig = EngineConfig.from_config
    EngineConfig.from_config = staticmethod(
        lambda cfg: dataclasses.replace(orig(cfg), metric="l1"))
    with tempfile.TemporaryDirectory() as out:
        cfg = Config(
            usePhotosCycle=True, outputDataDir=out,
            requiredExtractedPointsCount=300, featureExtractingThreshold=20,
            framesBatchSize=16, requiredMatchedPointsCount=80,
            knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
            useBundleAdjustment=True, BAMaxFramesCnt=8,
            BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
            tpu=TpuConfig(max_keypoints=2048, ransac_iters=1024,
                          pnp_ransac_iters=64, window_points=4096,
                          ba_max_iters=10, global_ba=False, ingest="device"))
        t = time.perf_counter()
        gd = app.slam_main(cfg, scene.K, frames=frames, seed=0)
        wall = time.perf_counter() - t
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    ate = absolute_trajectory_error(est, gt)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    print(f"jax l1 cpu: cameras {len(est)}/{n_frames}  ATE "
          f"{100 * ate / extent:.4f}% of extent  map {len(gd.points)} points"
          f"  wall {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
