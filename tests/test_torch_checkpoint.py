"""The port's checkpoint and resume on the CPU: a save/load round trip, a
run killed after a periodic snapshot and resumed from it against an
uninterrupted run (tests/test_runtime.py's twins), and a snapshot written
by the JAX package loaded into the port's engine."""

import dataclasses

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.io.media import ArraySource as JArraySource
from slam_indoor_code_tpu.runtime import DeviceEngine as JEngine
from slam_indoor_code_tpu.runtime import EngineConfig as JEngineConfig
from slam_indoor_code_tpu.runtime import save_checkpoint as jsave
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io.media import ArraySource
from slam_indoor_code_tpu_torch.runtime import (DeviceEngine, EngineConfig,
                                                checkpoint_next_fid,
                                                load_checkpoint,
                                                save_checkpoint)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rt_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


# tests/test_runtime.py::test_checkpoint_roundtrip's engine configuration
_ECFG = dict(max_keypoints=256, ring=14, map_cap=8192, window=4,
             window_points=1024, required_matched=30,
             distance_threshold=500.0, ransac_iters=128, pnp_iters=64,
             ratio=0.8, threshold=20.0)


def test_checkpoint_roundtrip(rt_scene, tmp_path):
    """save/load of the whole state resumes a run: the restored engine
    holds the saved state, cursors and generator, and tracks on."""
    frames = [rt_scene.render(i) for i in range(14)]
    cfg = EngineConfig(**_ECFG)
    e1 = DeviceEngine(ArraySource(frames[:8]), rt_scene.K, cfg, batch_size=6,
                      required_extracted=50, device="cpu")
    e1.run()
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, e1)
    data = np.load(ck)
    assert {"host_gen_state", "host_fast_threshold", "host_flushed_ids",
            "obs_n"} <= set(data.files)
    assert checkpoint_next_fid(ck) == e1._prev_fid + 1

    e2 = DeviceEngine(ArraySource(frames[8:]), rt_scene.K, cfg, batch_size=6,
                      required_extracted=50, seed=99, device="cpu")
    load_checkpoint(ck, e2)
    for name, t in e1.state.tensors().items():
        got = getattr(e2.state, name)
        assert got.dtype == t.dtype, name
        assert torch.equal(got, t), name
    assert torch.equal(e2.gen.get_state(), e1.gen.get_state())
    assert e2.frames_accepted == e1.frames_accepted
    assert e2._prev_fid == e1._prev_fid
    assert e2.flushed_ids == e1.flushed_ids
    e2.run(e1.state.pose_R.numpy(), e1.state.pose_t.numpy())
    assert e2.frames_accepted >= e1.frames_accepted
    assert int(e2.state.map_count) > int(e1.state.map_count)


def test_old_snapshot_defaults_and_shape_check(rt_scene, tmp_path):
    """A pre-v4/v5 snapshot (no win_map_base, step_ema or track anchors)
    loads with the JAX loader's defaults; an engine of another shape is
    refused field by field."""
    from slam_indoor_code_tpu_torch.geometry.rotations import \
        matrix_to_rodrigues

    frames = [rt_scene.render(i) for i in range(8)]
    cfg = EngineConfig(**_ECFG)
    e1 = DeviceEngine(ArraySource(frames), rt_scene.K, cfg, batch_size=6,
                      required_extracted=50, device="cpu")
    e1.run()
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, e1)
    old = {k: v for k, v in np.load(ck).items() if k not in (
        "state_win_map_base", "state_step_ema", "state_prev_anchor_xy",
        "state_prev_anchor_cam")}
    np.savez(str(tmp_path / "old.npz"), **old)
    e2 = DeviceEngine(ArraySource([]), rt_scene.K, cfg, batch_size=6,
                      required_extracted=50, device="cpu")
    load_checkpoint(str(tmp_path / "old.npz"), e2)
    assert int(e2.state.win_map_base) == 0 and float(e2.state.step_ema) == 0
    assert torch.equal(e2.state.prev_anchor_xy, e1.state.prev_xy)
    cam6 = torch.cat([matrix_to_rodrigues(e1.state.pose_R), e1.state.pose_t])
    assert torch.equal(e2.state.prev_anchor_cam,
                       cam6.expand_as(e2.state.prev_anchor_cam))
    assert torch.equal(e2.state.map_points, e1.state.map_points)
    other = DeviceEngine(ArraySource([]), rt_scene.K,
                         dataclasses.replace(cfg, max_keypoints=128),
                         batch_size=6, required_extracted=50, device="cpu")
    with pytest.raises(ValueError, match="EngineConfig mismatch"):
        load_checkpoint(ck, other)


def test_orb_checkpoint_keeps_bit_words(rt_scene, tmp_path):
    """ORB's int32 bit words survive the round trip as int32 (the loader
    casts to the engine's dtypes; uint32 words of a JAX snapshot become the
    int32 view)."""
    frames = [rt_scene.render(i) for i in range(8)]
    cfg = EngineConfig(**_ECFG, descriptor="orb", metric="hamming")
    e1 = DeviceEngine(ArraySource(frames), rt_scene.K, cfg, batch_size=6,
                      required_extracted=50, device="cpu")
    e1.run()
    assert (e1.state.map_desc[: int(e1.state.map_count)] < 0).any()
    ck = str(tmp_path / "orb.npz")
    save_checkpoint(ck, e1)
    e2 = DeviceEngine(ArraySource([]), rt_scene.K, cfg, batch_size=6,
                      required_extracted=50, device="cpu")
    load_checkpoint(ck, e2)
    assert e2.state.map_desc.dtype == torch.int32
    assert torch.equal(e2.state.map_desc, e1.state.map_desc)
    assert torch.equal(e2.state.ring_desc, e1.state.ring_desc)


def _cfg(out, **tpu_over):
    """tests/test_runtime.py::test_checkpoint_kill_and_resume_identical_tail's
    configuration, device ingest pinned."""
    tpu = tconfig.TpuConfig(max_keypoints=512, ransac_iters=256,
                            pnp_ransac_iters=128, window_points=4096,
                            ba_max_iters=12, rebind_cap=4096,
                            ingest="device", **tpu_over)
    return tconfig.Config(
        usePhotosCycle=True, outputDataDir=str(out),
        requiredExtractedPointsCount=80, featureExtractingThreshold=20,
        framesBatchSize=6, requiredMatchedPointsCount=30,
        knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
        useBundleAdjustment=True, BAMaxFramesCnt=4,
        BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
        tpu=tpu)


class KilledSource(ArraySource):
    """The media fails once ``kill_after`` frames were read."""

    def __init__(self, frames, kill_after):
        super().__init__(frames)
        self._kill_after = kill_after

    def next_frame(self):
        if self._i >= self._kill_after:
            raise RuntimeError("simulated crash")
        return super().next_frame()


def test_kill_and_resume_identical_run(rt_scene, tmp_path):
    """Through ``slam_main``: a run killed by a media failure after periodic
    snapshots, then resumed from the last one, gives what an uninterrupted
    run gives — the whole trajectory (the snapshot's flushed part is
    re-emitted) and the map, bit for bit on the CPU (the JAX twin asks
    1e-5/1e-4 of the overlapping cameras).  The periodic i % 14 workload
    of the JAX twin keeps the kill well after several snapshots although
    ingest prefetches up to ~42 frames ahead of acceptance."""
    frames = [rt_scene.render(i % 14) for i in range(64)]
    gd_a = tapp.slam_main(_cfg(tmp_path / "a"), rt_scene.K,
                          frames=list(frames), device="cpu")
    ck = str(tmp_path / "run.npz")
    with pytest.raises(RuntimeError, match="simulated crash"):
        tapp.slam_main(_cfg(tmp_path / "b1", checkpoint_path=ck,
                            checkpoint_every=4), rt_scene.K,
                       frames=KilledSource(list(frames), kill_after=56),
                       device="cpu")
    assert checkpoint_next_fid(ck) > 8
    gd_b = tapp.slam_main(_cfg(tmp_path / "b2", resume_path=ck), rt_scene.K,
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


@pytest.mark.parametrize("descriptor,metric", [("sift", "l2"),
                                               ("orb", "hamming")])
def test_jax_written_checkpoint_loads_into_the_port(rt_scene, tmp_path,
                                                    descriptor, metric):
    """The JAX engine tracks 8 frames and writes a snapshot; the port's
    ``load_checkpoint`` reads it: every state field equals the JAX state
    (uint32 words as their int32 view, int32 counters and ids as int64),
    and the host cursors and flushed trajectory come across."""
    frames = [rt_scene.render(i) for i in range(8)]
    jcfg = JEngineConfig(**_ECFG, descriptor=descriptor, metric=metric)
    je = JEngine(JArraySource(frames), rt_scene.K, jcfg, batch_size=6,
                 required_extracted=50)
    je.run()
    ck = str(tmp_path / "jax.npz")
    jsave(ck, je)
    want = {k: np.asarray(v) for k, v in je.state._asdict().items()}

    te = DeviceEngine(ArraySource([]), rt_scene.K,
                      EngineConfig(**dataclasses.asdict(jcfg)), batch_size=6,
                      required_extracted=50, device="cpu")
    load_checkpoint(ck, te)
    got = te.state.tensors()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        elif w.dtype.kind in "iu":
            w = w.astype(np.int64)
            assert g.dtype == np.int64, name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert te.frames_accepted == je.frames_accepted
    assert te._prev_fid == je._prev_fid
    assert te._win_ids == list(je._win_ids)
    assert te.flushed_ids == list(je.flushed_ids)
    np.testing.assert_array_equal(np.stack(te.flushed_t),
                                  np.stack(je.flushed_t))
