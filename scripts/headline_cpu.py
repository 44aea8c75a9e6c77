"""The headline scene on the CPU, through either package: the frames and
configuration that chip_smoke.py drives the port with on the card (the
bench.py headline: FHD, SIFT, ratio 0.8, 2048 keypoints, batch 16, Huber BA
every 8 frames, device ingest) over the seed-7 synthetic hallway, with L2
or L1 matching of the SIFT descriptors, or with ORB and Hamming matching
(only ``useFM-ORB`` set, chip_smoke.py's ORB phase).  ``--ingest host``
detects on the host instead and runs the streaming loop with the host
descriptor of ``--host-desc`` ("same", chip_smoke.py's stream phase; "auto"
is "hybrid" for SIFT and "orb" for ORB, its hybrid and hostorb phases) and
the pooled gray of ``--downscale`` (2, the JAX default).  ``--classic`` runs
the classic host conductor (``tpu.device_runtime=false``, chip_smoke.py's
classic phase) instead of the device runtime.  It tells what the
port gives on the CPU from what it gives on the card, and both from the JAX
package.

    python scripts/headline_cpu.py torch l1     # the port, device="cpu"
    JAX_PLATFORMS=cpu python scripts/headline_cpu.py jax l2 --seed 1
    python scripts/headline_cpu.py torch l2 --ingest host --downscale 2
    python scripts/headline_cpu.py torch l2 --ingest host --host-desc auto
    python scripts/headline_cpu.py jax l2 --classic --seed 3

``--seed`` seeds the RANSAC draws (the engine's generator or PRNG key; the
frames stay the seed-7 scene).  Prints one line: package, metric, seed,
cameras, ATE as a share of the trajectory extent, map points and wall
seconds.  The ``torch`` runs import nothing of JAX.  Memory: a few GB at 32
FHD frames; 20-60 s per L2 run, 3.5-7 min per L1 run.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _modules(package: str):
    """(app, config, EngineConfig, make_scene, ATE, camera_centers) of one
    package."""
    if package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        os.environ.setdefault("SLAM_TPU_NO_COMPILE_CACHE", "1")
        import jax

        jax.config.update("jax_platforms", "cpu")
        import slam_indoor_code_tpu as pkg
    else:
        import torch

        torch.set_num_threads(4)
        import slam_indoor_code_tpu_torch as pkg
    from importlib import import_module

    name = pkg.__name__
    ate = import_module(f"{name}.metrics.ate")
    return (import_module(f"{name}.app"), import_module(f"{name}.config"),
            import_module(f"{name}.runtime").EngineConfig,
            import_module(f"{name}.testing").make_scene,
            ate.absolute_trajectory_error, ate.camera_centers)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("metric", choices=("l1", "l2", "orb"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ingest", choices=("device", "host"), default="device")
    ap.add_argument("--downscale", type=int, default=2,
                    help="pooled-gray factor under host ingest")
    ap.add_argument("--host-desc", default="same",
                    choices=("same", "auto", "orb", "hybrid"),
                    help="tpu.host_descriptor under host ingest")
    ap.add_argument("--classic", action="store_true",
                    help="the classic host conductor "
                         "(tpu.device_runtime=false)")
    args = ap.parse_args()
    app, config, EngineConfig, make_scene, ate_fn, centers = _modules(
        args.package)
    n_frames = 32
    scene = make_scene(n_points=1500, n_frames=n_frames,
                       image_size=(1080, 1920), seed=7, baseline=0.25,
                       kind="hallway")
    frames = [scene.render(i) for i in range(n_frames)]
    if args.metric != "orb":
        orig = EngineConfig.from_config
        EngineConfig.from_config = staticmethod(
            lambda cfg: dataclasses.replace(orig(cfg), metric=args.metric))
    orb = args.metric == "orb"
    kw = {"device": "cpu"} if args.package == "torch" else {}
    with tempfile.TemporaryDirectory() as out:
        cfg = config.Config(
            usePhotosCycle=True, outputDataDir=out,
            requiredExtractedPointsCount=300, featureExtractingThreshold=20,
            framesBatchSize=16, requiredMatchedPointsCount=80,
            knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
            useBundleAdjustment=True, BAMaxFramesCnt=8,
            BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
            useFM_SIFT_BF=not orb, useFM_ORB=orb,
            tpu=config.TpuConfig(max_keypoints=2048, ransac_iters=1024,
                                 pnp_ransac_iters=64, window_points=4096,
                                 ba_max_iters=10, global_ba=False,
                                 ingest=args.ingest,
                                 host_descriptor=args.host_desc,
                                 streaming=True,
                                 device_runtime=not args.classic,
                                 ingest_downscale=args.downscale))
        t = time.perf_counter()
        gd = app.slam_main(cfg, scene.K, frames=frames, seed=args.seed, **kw)
        wall = time.perf_counter() - t
    est = centers(gd.rotations, gd.positions)
    ids = np.asarray(gd.frame_ids, np.int64)
    if len(ids) != len(est) and len(est) == n_frames:
        # the JAX package's classic conductor records no frame ids; with
        # every frame a camera they are the frames in order
        ids = np.arange(n_frames)
    gt = scene.centers()[ids]
    ate = ate_fn(est, gt)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    ingest = ("device" if args.ingest == "device"
              else f"host d={args.downscale} {args.host_desc} streaming")
    if args.classic:
        ingest += " classic"
    print(f"{args.package} {args.metric} seed {args.seed} {ingest} cpu: "
          f"cameras "
          f"{len(est)}/{n_frames}  ATE {100 * ate / extent:.4f}% of extent"
          f"  map {len(gd.points)} points  wall {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
