"""The port's distribution layer (parallel/, the meshed engine,
run_sequences_parallel) against the JAX package's, on explicit 8-shard CPU
meshes (the JAX tests' virtual 8-device CPU platform): twins of
tests/test_parallel.py.

Tolerances: ``ShardedFrontend`` keeps ``valid`` and ``num_matches`` exact
and ``xy`` to 1e-5 against the unsplit port and against the JAX package's
``ShardedFrontend``.  ``ShardedBA`` is held to the port's
``bundle_adjust_window`` with test_parallel.py's rules (cams 5e-3, cost 5 %,
points 0.15 / median 0.05; poses within 0.3°), and to the JAX package's
``ShardedBA`` on the same problems to 1e-3 relative final cost and 5e-4 in
the cameras: on the JAX worker's problem, and on test_parallel.py's for
its first four LM iterations (after them that problem slides along its
weak intrinsics valley, where JAX's own 8- and 1-shard solves part by 1e-3
in the cameras; at 12 iterations it is held to test_parallel.py's rule).
A mesh of one device gives the unsharded BA bit for bit.  Each of two
parallel sequences equals its own solo run bit for bit.  ``slam_main`` on
an 8-shard mesh keeps the single-device run's frame ids, its trajectory
within 0.03 of the extent of it, and its ATE within 0.02 of the extent of
the JAX package's meshed run's.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.parallel import ShardedBA as JShardedBA
from slam_indoor_code_tpu.parallel import ShardedFrontend as JShardedFrontend
from slam_indoor_code_tpu.parallel import make_mesh as jmake_mesh
from slam_indoor_code_tpu.models import frontend as jfe
from slam_indoor_code_tpu.solver import BAConfig as JBAConfig
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch.geometry.rotations import (
    matrix_to_rodrigues, rodrigues_to_matrix)
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.models import frontend as fe
from slam_indoor_code_tpu_torch.parallel import (ShardedBA, ShardedFrontend,
                                                 make_mesh, map_batch)
from slam_indoor_code_tpu_torch.parallel.worker import build_ba_problem
from slam_indoor_code_tpu_torch.solver.ba import (BAConfig,
                                                  bundle_adjust_window)

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((8,), ("batch",), devices=[CPU] * 8)


@pytest.fixture(scope="module")
def pscene():
    # tests/conftest.py's session scene
    return make_scene(n_points=500, n_frames=10, seed=3)


def test_mesh_has_8_devices(mesh):
    assert mesh.shape["batch"] == 8 and mesh.size == 8
    assert mesh.devices.shape == (8,) and mesh.group is None
    assert mesh.device == CPU


def test_make_mesh_counts_devices():
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        make_mesh((4,), ("batch",), devices=[CPU] * 2)
    m = make_mesh((2, 4), ("seq", "batch"), devices=[CPU] * 8)
    assert m.shape == {"seq": 2, "batch": 4} and m.devices.shape == (2, 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA card"):
            make_mesh((2,))


@pytest.mark.parametrize("descriptor,metric", [("orb", "hamming"),
                                               ("sift", "l2")])
def test_sharded_frontend_matches_unsharded_and_jax(mesh, pscene, descriptor,
                                                    metric):
    """Twin of test_parallel.py::test_sharded_frontend_matches_unsharded
    (ORB/Hamming there; SIFT/L2 too here)."""
    fcfg = fe.FrontendConfig(max_keypoints=256, threshold=20.0,
                             descriptor=descriptor, ratio=0.8, metric=metric)
    frames = np.stack([pscene.render(i) for i in range(8)])
    sf = ShardedFrontend(mesh, fcfg)
    assert sf.pad_to_devices(13) == 16
    rgb = torch.from_numpy(frames)
    res_sh = sf.extract_and_describe_batch(rgb)
    res_ref = fe.extract_and_describe_batch(fcfg, rgb)
    np.testing.assert_array_equal(res_sh["valid"].numpy(),
                                  res_ref["valid"].numpy())
    np.testing.assert_allclose(res_sh["xy"].numpy(), res_ref["xy"].numpy(),
                               atol=1e-5)
    prev = fe.extract_and_describe(fcfg, torch.from_numpy(pscene.render(0)))
    mask = torch.ones(8, dtype=torch.bool)
    m_sh = sf.match_against_batch(prev["desc"], prev["valid"],
                                  res_sh["desc"], res_sh["valid"], mask)
    m_ref = fe.match_against_batch(fcfg, prev["desc"], prev["valid"],
                                   res_ref["desc"], res_ref["valid"], mask)
    np.testing.assert_array_equal(m_sh["num_matches"].numpy(),
                                  m_ref["num_matches"].numpy())

    jm = jmake_mesh((8,), ("batch",))
    jcfg = jfe.FrontendConfig(max_keypoints=256, threshold=20.0,
                              descriptor=descriptor, ratio=0.8, metric=metric)
    jsf = JShardedFrontend(jm, jcfg)
    jres = jsf.extract_and_describe_batch(jnp.asarray(frames))
    np.testing.assert_array_equal(res_sh["valid"].numpy(),
                                  np.asarray(jres["valid"]))
    np.testing.assert_allclose(res_sh["xy"].numpy(), np.asarray(jres["xy"]),
                               atol=1e-5)
    jprev = jfe.extract_and_describe(jcfg, jnp.asarray(pscene.render(0)))
    jmatch = jsf.match_against_batch(jprev["desc"], jprev["valid"],
                                     jres["desc"], jres["valid"],
                                     jnp.ones(8, bool))
    np.testing.assert_array_equal(m_sh["num_matches"].numpy(),
                                  np.asarray(jmatch["num_matches"]))


def test_map_batch_pads_and_keeps_order(mesh):
    """13 rows over 8 shards: zero-padded to 16, gathered in shard order and
    cut back to 13; a tuple output keeps its structure."""
    x = torch.arange(13 * 3, dtype=torch.float32).reshape(13, 3)
    seen = []

    def fn(c, xs):
        seen.append(xs.shape[0])
        return xs * c, xs.sum(1)

    y, s = map_batch(mesh, fn, (x,), (torch.tensor(2.0),))
    assert seen == [2] * 8
    torch.testing.assert_close(y, 2 * x, rtol=0, atol=0)
    torch.testing.assert_close(s, x.sum(1), rtol=0, atol=0)


def _ba_problem(scene, rng, F=4, Pn=120):
    # tests/test_parallel.py's problem, with the port's rotations
    pts_gt = scene.points[:Pn]
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2],
                   scene.K[1, 2]], np.float32)
    uv = np.zeros((F, Pn, 2), np.float32)
    idx = np.tile(np.arange(Pn, dtype=np.int32), (F, 1))
    mask = np.zeros((F, Pn), bool)
    cams = np.zeros((F, 6), np.float32)
    for f in range(F):
        uvf, vis = scene.project(f, noise=0.3, rng=rng)
        uv[f] = uvf[:Pn]
        mask[f] = vis[:Pn]
        aa = matrix_to_rodrigues(torch.from_numpy(
            scene.rotations[f].astype(np.float32))).numpy()
        cams[f, :3] = aa + (rng.normal(0, 0.02, 3) if f else 0)
        cams[f, 3:] = scene.translations[f] + (rng.normal(0, 0.02, 3)
                                               if f else 0)
    pts0 = (pts_gt + rng.normal(0, 0.05, pts_gt.shape)).astype(np.float32)
    return K4, cams, pts0, uv, idx, mask, np.ones(Pn, bool)


def _t(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def test_sharded_ba_matches_single_device(mesh, pscene):
    """Twin of test_parallel.py::test_sharded_ba_matches_single_device."""
    prob = _ba_problem(pscene, np.random.default_rng(77))
    cfg = BAConfig(loss="huber", loss_param=2.0, max_iters=12)
    _, cams_s, pts_s, info = bundle_adjust_window(cfg, *_t(prob))
    res = ShardedBA(mesh, cfg, window=4).solve(*prob)
    np.testing.assert_allclose(res.cams, cams_s.numpy(), atol=5e-3)
    assert res.final_cost < 0.2 * res.initial_cost
    fc = float(info["final_cost"])
    assert abs(res.final_cost - fc) / fc < 0.05
    np.testing.assert_allclose(res.points, pts_s.numpy(), atol=0.15)
    assert np.median(np.linalg.norm(res.points - pts_s.numpy(), axis=1)) \
        < 0.05


def test_sharded_ba_improves_poses(mesh, pscene):
    """Twin of test_parallel.py::test_sharded_ba_improves_poses."""
    prob = _ba_problem(pscene, np.random.default_rng(78))
    res = ShardedBA(mesh, BAConfig(loss="trivial", max_iters=15),
                    window=4).solve(*prob)
    Rs = rodrigues_to_matrix(torch.from_numpy(
        res.cams[:, :3].astype(np.float32))).numpy()
    for f in range(1, 4):
        Rerr = Rs[f] @ pscene.rotations[f].T
        ang = np.degrees(np.arccos(np.clip((np.trace(Rerr) - 1) / 2, -1, 1)))
        assert ang < 0.3


@pytest.mark.parametrize("case", ["worker", "window4", "window12"])
def test_sharded_ba_matches_jax(mesh, pscene, case):
    """The port's ShardedBA against the JAX package's on the same problem
    and the same 8-shard split."""
    if case == "worker":
        prob, F = build_ba_problem(), 4
        kw = dict(loss="huber", loss_param=2.0, max_iters=8,
                  fix_intrinsics=True)
    else:
        prob, F = _ba_problem(pscene, np.random.default_rng(77)), 4
        kw = dict(loss="huber", loss_param=2.0,
                  max_iters=4 if case == "window4" else 12)
    res = ShardedBA(mesh, BAConfig(**kw), window=F).solve(*prob)
    jres = JShardedBA(jmake_mesh((8,), ("batch",)), JBAConfig(**kw),
                      window=F).solve(*prob)
    assert abs(res.initial_cost - jres.initial_cost) / jres.initial_cost \
        < 1e-5
    rel = abs(res.final_cost - jres.final_cost) / jres.final_cost
    if case == "window12":
        assert rel < 0.05
        np.testing.assert_allclose(res.cams, jres.cams, atol=5e-3)
    else:
        assert rel < 1e-3, (res.final_cost, jres.final_cost)
        np.testing.assert_allclose(res.cams, jres.cams, atol=5e-4)


def test_mesh_of_one_device_is_unsharded_bitwise(pscene):
    """bundle_adjust_window on a one-device mesh is the unsharded solve bit
    for bit; on 8 shards it keeps test_parallel.py's rules."""
    args = _t(_ba_problem(pscene, np.random.default_rng(77)))
    cfg = BAConfig(loss="huber", loss_param=2.0, max_iters=12)
    ref = bundle_adjust_window(cfg, *args)
    one = bundle_adjust_window(cfg, *args,
                               mesh=make_mesh((1,), devices=[CPU]))
    for a, b in zip(ref[:3], one[:3]):
        assert torch.equal(a, b)
    assert torch.equal(ref[3]["final_cost"], one[3]["final_cost"])
    eight = bundle_adjust_window(cfg, *args,
                                 mesh=make_mesh((8,), devices=[CPU] * 8))
    np.testing.assert_allclose(eight[1].numpy(), ref[1].numpy(), atol=5e-3)
    fc = float(ref[3]["final_cost"])
    assert abs(float(eight[3]["final_cost"]) - fc) / fc < 0.05


def test_launch_counter_is_thread_safe():
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    def fn():
        pass

    fn.launches = 0
    fn.hamming_launches = 0

    def bump():
        for _ in range(20000):
            ck._count(fn, "launches", "hamming_launches")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fn.launches == fn.hamming_launches == 8 * 20000


def _seq_cfg(tconfig, out, **tpu):
    return tconfig.Config(
        usePhotosCycle=True, outputDataDir=str(out),
        requiredExtractedPointsCount=40, featureExtractingThreshold=15,
        framesBatchSize=5, requiredMatchedPointsCount=20,
        knnMatcherDistance=0.85, RPDistanceThreshold=500.0,
        tpu=tconfig.TpuConfig(max_keypoints=256, ransac_iters=128,
                              pnp_ransac_iters=64, window_points=1024, **tpu))


def test_multi_sequence_parallel(tmp_path):
    """Twin of test_parallel.py::test_multi_sequence_parallel; each
    sequence also equals its own solo run (same seed) bit for bit."""
    from slam_indoor_code_tpu_torch import config as tconfig
    from slam_indoor_code_tpu_torch.app import (run_sequences_parallel,
                                                slam_main)

    scenes = [make_scene(500, 10, seed=s, baseline=0.3, kind="hallway",
                         image_size=(120, 160)) for s in (1, 2)]
    cfgs = [_seq_cfg(tconfig, tmp_path / f"seq{i}") for i in range(2)]
    frames = [[sc.render(j) for j in range(10)] for sc in scenes]
    out = run_sequences_parallel(cfgs, [sc.K for sc in scenes], frames,
                                 device="cpu")
    assert len(out) == 2
    for i, (sc, gd) in enumerate(zip(scenes, out)):
        assert len(gd.rotations) >= 6
        est = camera_centers(gd.rotations, gd.positions)
        gt = sc.centers()[: len(est)]
        ate = absolute_trajectory_error(est, gt)
        assert ate < 0.15 * np.linalg.norm(gt.max(0) - gt.min(0))
        solo = slam_main(_seq_cfg(tconfig, tmp_path / f"solo{i}"), sc.K,
                         frames=frames[i], seed=i, device="cpu")
        np.testing.assert_array_equal(gd.frame_ids, solo.frame_ids)
        np.testing.assert_array_equal(np.asarray(gd.rotations),
                                      np.asarray(solo.rotations))
        np.testing.assert_array_equal(np.asarray(gd.positions),
                                      np.asarray(solo.positions))
        np.testing.assert_array_equal(gd.points, solo.points)


def test_multi_sequence_errors_and_profile_dir(tmp_path):
    from slam_indoor_code_tpu_torch import config as tconfig
    from slam_indoor_code_tpu_torch.app import run_sequences_parallel

    sc = make_scene(200, 4, seed=1, image_size=(120, 160))
    frames = [sc.render(j) for j in range(4)]
    bad = _seq_cfg(tconfig, tmp_path / "bad", ingest="nonsense")
    good = _seq_cfg(tconfig, tmp_path / "good")
    with pytest.raises(RuntimeError, match="sequence 1 failed") as e:
        run_sequences_parallel([good, bad], [sc.K] * 2, [frames] * 2,
                               device="cpu")
    assert isinstance(e.value.__cause__, ValueError)
    prof = _seq_cfg(tconfig, tmp_path / "p", profile_dir=str(tmp_path))
    with pytest.raises(ValueError, match="profile_dir"):
        run_sequences_parallel([prof], [sc.K], [frames], device="cpu")


def test_engine_mesh_turns_streaming_off():
    from slam_indoor_code_tpu_torch.io.media import ArraySource
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig

    sc = make_scene(200, 2, seed=1)
    cfg = EngineConfig(max_keypoints=128, window_points=256,
                       ingest_mode="host", host_desc="same", streaming=True,
                       mesh_shape=(4,))
    eng = DeviceEngine(ArraySource([sc.render(0)]), sc.K, cfg, batch_size=4,
                       required_extracted=10, device="cpu")
    assert not eng._will_stream
    assert eng.mesh.size == 4 and eng.mesh.local_devices == [CPU] * 4
    eng = DeviceEngine(ArraySource([sc.render(0)]), sc.K,
                       dataclasses.replace(cfg, mesh_shape=()),
                       batch_size=4, required_extracted=10, device="cpu")
    assert eng._will_stream and eng.mesh is None


def test_slam_main_on_mesh_matches_single_device(tmp_path):
    """Twin of test_parallel.py::test_slam_main_on_mesh_matches_single_
    device: the port on an 8-shard CPU mesh against its single-device run
    and against the JAX package's meshed run."""
    import os

    from slam_indoor_code_tpu import app as japp
    from slam_indoor_code_tpu import config as jconfig
    from slam_indoor_code_tpu.runtime import steps as jsteps
    from slam_indoor_code_tpu_torch import app as tapp
    from slam_indoor_code_tpu_torch import config as tconfig

    scene = make_scene(n_points=700, n_frames=12, seed=5, baseline=0.3)
    frames = [scene.render(i) for i in range(12)]

    def cfg(mod, mesh_shape, sub):
        out = tmp_path / sub
        os.makedirs(out, exist_ok=True)
        return mod.Config(
            usePhotosCycle=True, outputDataDir=str(out),
            requiredExtractedPointsCount=80, featureExtractingThreshold=20,
            framesBatchSize=6, requiredMatchedPointsCount=30,
            knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
            useBundleAdjustment=True, BAMaxFramesCnt=8,
            BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
            tpu=mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                              pnp_ransac_iters=128, window_points=2048,
                              ba_max_iters=10, mesh_shape=mesh_shape))

    gd_1 = tapp.slam_main(cfg(tconfig, (), "single"), scene.K, frames=frames,
                          device="cpu")
    gd_8 = tapp.slam_main(cfg(tconfig, (8,), "mesh8"), scene.K,
                          frames=frames, device="cpu")
    try:
        gd_j = japp.slam_main(cfg(jconfig, (8,), "jax8"), scene.K,
                              frames=frames)
    finally:
        jsteps.set_active_mesh(None)   # the JAX package's mesh is global

    assert len(gd_8.rotations) == len(gd_1.rotations) == len(gd_j.rotations)
    np.testing.assert_array_equal(gd_8.frame_ids, gd_1.frame_ids)
    np.testing.assert_array_equal(gd_8.frame_ids, gd_j.frame_ids)
    c1 = camera_centers(gd_1.rotations, gd_1.positions)
    c8 = camera_centers(gd_8.rotations, gd_8.positions)
    ext = np.linalg.norm(c1.max(0) - c1.min(0))
    assert absolute_trajectory_error(c8, c1) < 0.03 * ext
    gt = scene.centers()[gd_8.frame_ids]
    gext = np.linalg.norm(gt.max(0) - gt.min(0))
    ate = absolute_trajectory_error(c8, gt)
    assert ate < 0.08 * gext
    ate_j = absolute_trajectory_error(
        camera_centers(gd_j.rotations, gd_j.positions), gt)
    assert abs(ate - ate_j) <= 0.02 * gext, (ate / gext, ate_j / gext)
