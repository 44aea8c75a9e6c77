"""One process of a multi-process run (counterpart of the JAX package's
scripts/_distributed_worker.py): start one per rank, all with the same
coordinator address.

    python -m slam_indoor_code_tpu_torch.parallel.worker MODE \\
        <coordinator host:port> <nproc> <rank> [--device cuda|cpu]

Modes:

* ``init``     — join the process group (``initialize_distributed``; rank
  0 listens at the coordinator) and sum one row per process across it:
  prints ``proc R: global psum S OK``.
* ``ba``       — ``ShardedBA.solve_multiprocess`` on a mesh of one shard
  per process: the reduced camera system of every LM iteration is summed
  across the process boundary.  Each process also solves the same problem
  on a one-shard mesh of its own and holds the two to 1e-3 relative final
  cost and 5e-4 in the cameras.  ``--frames/--slots/--points`` size the
  problem (the JAX worker's 4 × 64 over 96 points by default).
* ``pipeline`` — ``slam_main`` with ``tpu.mesh_shape=(nproc,)`` across the
  processes (host ingest, the candidate matches and the BA's observations
  split over them), then the same scene without a mesh in each process;
  the two trajectories must agree within 3 % of the extent.  Host ingest
  takes the default host descriptor, "hybrid" (pooled SIFT beside the
  host's ORB bits), as the JAX worker does.

The device defaults to CUDA: NCCL where every rank has a card of its own,
else gloo (ranks that share a card, or ``--device cpu``).  Nothing happens
at import; every mode ends with ``destroy_process_group``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def build_ba_problem(seed=0, F=4, Kslots=64, Pn=96):
    """Deterministic synthetic BA window every process builds identically
    (same seed): points ahead of a small camera arc, projected with
    noise."""
    rng = np.random.default_rng(seed)
    K4 = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    Km = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float64)
    pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (Pn, 3)).astype(np.float32)
    cams = np.zeros((F, 6), np.float32)
    uv = np.zeros((F, Kslots, 2), np.float32)
    lidx = np.zeros((F, Kslots), np.int32)
    omask = np.zeros((F, Kslots), bool)
    for f in range(F):
        cams[f, 3] = -0.3 * f          # translate along x
        t = cams[f, 3:]
        pix = (pts + t) @ Km.T
        uvf = pix[:, :2] / pix[:, 2:]
        ids = rng.permutation(Pn)[:Kslots]
        uv[f] = uvf[ids] + rng.normal(0, 0.3, (Kslots, 2))
        lidx[f] = ids
        omask[f] = True
    cams_n = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    pts_n = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    pmask = np.ones(Pn, bool)
    return K4, cams_n, pts_n, uv, lidx, omask, pmask


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def init_main(args, dev: torch.device) -> str:
    from .mesh import all_reduce_sum, make_mesh

    mesh = make_mesh((args.nproc,), ("batch",), devices=[dev])
    assert mesh.world == args.nproc, mesh
    rows = np.arange(1, args.nproc + 1, dtype=np.float32)[:, None] * np.ones(
        (1, 8), np.float32)
    mine = torch.from_numpy(rows[args.rank]).to(dev)
    total = float(all_reduce_sum(mesh, mine.sum()))
    assert total == float(rows.sum()), (total, rows.sum())
    return f"global psum {total} OK"


def ba_main(args, dev: torch.device) -> str:
    from ..solver.ba import BAConfig
    from . import mesh as mesh_mod
    from .ba_sharded import ShardedBA
    from .mesh import Mesh, make_mesh

    prob = build_ba_problem(F=args.frames, Kslots=args.slots, Pn=args.points)
    cfg = BAConfig(loss="huber", loss_param=2.0, max_iters=8,
                   fix_intrinsics=True)
    gmesh = make_mesh((args.nproc,), ("batch",), devices=[dev])
    assert gmesh.world == args.nproc, gmesh
    sba = ShardedBA(gmesh, cfg, window=args.frames)
    # two solves: the first also connects the group's pairs; the seconds
    # spent inside the all-reduces (host staging included) are counted
    spent = {"s": 0.0, "n": 0}
    orig = mesh_mod.all_reduce_sum

    def timed_all_reduce(mesh, t):
        t0 = time.perf_counter()
        out = orig(mesh, t)
        spent["s"] += time.perf_counter() - t0
        spent["n"] += 1
        return out

    mesh_mod.all_reduce_sum = timed_all_reduce
    solves = []
    try:
        for _ in range(2):
            spent.update(s=0.0, n=0)
            _sync(dev)
            t = time.perf_counter()
            c0, c1, cams_g = sba.solve_multiprocess(*prob)
            solves.append((time.perf_counter() - t, spent["s"], spent["n"]))
    finally:
        mesh_mod.all_reduce_sum = orig
    assert c1 < c0, (c0, c1)

    # the same problem on a one-shard mesh of this process alone
    lmesh = Mesh(np.array([dev], dtype=object), ("batch",))
    t = time.perf_counter()
    ref = ShardedBA(lmesh, cfg, window=args.frames).solve(*prob)
    local_s = time.perf_counter() - t
    rel = abs(c1 - ref.final_cost) / max(ref.final_cost, 1e-9)
    assert rel < 1e-3, (c1, ref.final_cost)
    np.testing.assert_allclose(cams_g, ref.cams, atol=5e-4)
    times = "; ".join(f"solve {i + 1} {s:.4f} s ({n} all-reduces "
                      f"{c:.4f} s)" for i, (s, c, n) in enumerate(solves))
    return (f"cross-process BA cost {c0:.3f}->{c1:.3f} (local ref "
            f"{ref.final_cost:.3f}, rel {rel:.3g}, cams max|d| "
            f"{np.abs(cams_g - ref.cams).max():.3g}) {args.frames} frames "
            f"{args.points} points; {times}; local {local_s:.4f} s OK")


def pipeline_main(args, dev: torch.device) -> str:
    from ..app import slam_main
    from ..config import Config, TpuConfig
    from ..metrics import absolute_trajectory_error
    from ..metrics.ate import camera_centers
    from ..testing import make_scene

    # every process builds the identical scene (same seed)
    scene = make_scene(n_points=700, n_frames=12, seed=5, baseline=0.3)
    frames = [scene.render(i) for i in range(12)]

    def run(mesh_shape, tag):
        out = tempfile.mkdtemp(prefix=f"pipe2_{tag}_{args.rank}_")
        cfg = Config(
            usePhotosCycle=True, outputDataDir=out,
            requiredExtractedPointsCount=80, featureExtractingThreshold=20,
            framesBatchSize=6, requiredMatchedPointsCount=30,
            knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
            useBundleAdjustment=True, BAMaxFramesCnt=8,
            BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
            tpu=TpuConfig(max_keypoints=512, ransac_iters=256,
                          pnp_ransac_iters=128, window_points=2048,
                          ba_max_iters=10, mesh_shape=mesh_shape,
                          ingest="host", ingest_downscale=1))
        return slam_main(cfg, scene.K, frames=list(frames), device=dev)

    gd_g = run((args.nproc,), "global")
    gd_l = run((), "local")
    assert len(gd_g.rotations) == len(gd_l.rotations), (
        len(gd_g.rotations), len(gd_l.rotations))
    assert (np.asarray(gd_g.frame_ids) == np.asarray(gd_l.frame_ids)).all()
    cg = camera_centers(gd_g.rotations, gd_g.positions)
    cl = camera_centers(gd_l.rotations, gd_l.positions)
    ext = float(np.linalg.norm(cl.max(0) - cl.min(0)))
    ate_rel = absolute_trajectory_error(cg, cl) / max(ext, 1e-9)
    assert ate_rel < 0.03, f"mesh-vs-local ATE {100 * ate_rel:.2f}%"
    gt = scene.centers()[gd_g.frame_ids]
    ate_gt = absolute_trajectory_error(cg, gt) / max(
        float(np.linalg.norm(gt.max(0) - gt.min(0))), 1e-9)
    return (f"two-process pipeline cameras {len(gd_g.rotations)} map "
            f"{len(gd_g.points)} ate-vs-local {100 * ate_rel:.3f}% "
            f"ate-vs-gt {100 * ate_gt:.3f}% OK")


MODES = {"init": init_main, "ba": ba_main, "pipeline": pipeline_main}


def main(argv=None) -> None:
    from .. import resolve_device
    from .mesh import initialize_distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("coordinator")
    ap.add_argument("nproc", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--points", type=int, default=96)
    args = ap.parse_args(argv)
    if args.nproc < 2:
        ap.error("a multi-process run needs nproc >= 2")
    resolve_device(args.device)           # raises without a card
    if args.device == "cpu":
        torch.set_num_threads(1)
    backend = initialize_distributed(args.coordinator, args.nproc, args.rank,
                                     device=args.device)
    try:
        assert dist.get_world_size() == args.nproc
        dev = (torch.device("cuda", torch.cuda.current_device())
               if args.device == "cuda" else torch.device("cpu"))
        msg = MODES[args.mode](args, dev)
        print(f"proc {args.rank} ({backend}, {dev}): {msg}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
