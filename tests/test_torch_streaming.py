"""The port's host-ingest streaming runtime against the JAX package's, on
the CPU: twins of tests/test_runtime.py's host-ingest and streaming tests
on rt_scene (480x640, 14 frames), the port's streaming run held against the
JAX package's, ``queue_append`` exactly, and the host-descriptor rules."""

import dataclasses

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
from slam_indoor_code_tpu_torch.io.media import ArraySource
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig
from slam_indoor_code_tpu_torch.runtime import steps as tsteps

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rt_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


@pytest.fixture(scope="module")
def rt_frames(rt_scene):
    return [rt_scene.render(i) for i in range(14)]


def _cfg(mod, out, ba=True, **tpu_over):
    """tests/test_runtime.py's _cfg under host ingest ("same" descriptors,
    the pooled gray off as the engine turns it off below 1024 px), with
    its streaming tests' Huber BA every 4 frames."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12, ingest="host", ingest_downscale=1,
                        host_descriptor="same", streaming=True)
    tpu = dataclasses.replace(tpu, **tpu_over)
    base = dict(usePhotosCycle=True, outputDataDir=str(out),
                requiredExtractedPointsCount=80, featureExtractingThreshold=20,
                framesBatchSize=6, requiredMatchedPointsCount=30,
                knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
                useBundleAdjustment=ba, tpu=tpu)
    if ba:
        base.update(BAMaxFramesCnt=4, BAUseHuberLossFunction=True,
                    BAHuberLossFunctionParameter=2.0)
    return mod.Config(**base)


def _rel_ate(scene, gd):
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    return absolute_trajectory_error(est, gt) / np.linalg.norm(
        gt.max(0) - gt.min(0))


def _ids(gd):
    return [int(f) for f in gd.frame_ids]


@pytest.fixture(scope="module")
def runs(rt_scene, rt_frames, tmp_path_factory):
    """The port streamed and classic, the JAX package streamed, on the same
    frames and configuration."""
    out = {}
    for name, stream in (("stream", True), ("classic", False)):
        d = tmp_path_factory.mktemp(name)
        out[name] = (tapp.slam_main(_cfg(tconfig, d, streaming=stream),
                                    rt_scene.K, frames=list(rt_frames),
                                    device="cpu"), d)
    d = tmp_path_factory.mktemp("jax")
    out["jax"] = (japp.slam_main(_cfg(jconfig, d), rt_scene.K,
                                 frames=list(rt_frames)), d)
    return out


def test_host_ingest_end_to_end(rt_scene, runs):
    """tests/test_runtime.py's test_engine_host_ingest_e2e: host ingest
    runs the whole pipeline (here through the streaming loop) and carries
    source frame ids for every camera."""
    gd, out = runs["stream"]
    assert len(gd.rotations) >= 10
    assert len(gd.frame_ids) == len(gd.rotations)
    assert (np.diff(gd.frame_ids) > 0).all()
    assert _rel_ate(rt_scene, gd) < 0.08
    main = (out / "main.txt").read_text()
    assert "Bundle Adjustment statistics" in main
    assert "Features count in frames added to batch" in main


def test_streaming_matches_classic_and_jax(rt_scene, runs):
    """tests/test_runtime.py's test_streaming_matches_classic_host_ingest,
    and the port's streaming run against the JAX package's: the same frame
    schedule, ATE < 0.05 of the extent and within 0.02 of the others
    (RANSAC draws differ between the loops and the two generators)."""
    gd_s, gd_c, gd_j = (runs[k][0] for k in ("stream", "classic", "jax"))
    assert _ids(gd_s) == _ids(gd_c)
    assert _ids(gd_s) == _ids(gd_j)
    rel_s, rel_c, rel_j = (_rel_ate(rt_scene, g) for g in (gd_s, gd_c, gd_j))
    assert rel_s < 0.05, rel_s
    assert abs(rel_s - rel_c) < 0.02, (rel_s, rel_c)
    assert abs(rel_s - rel_j) < 0.02, (rel_s, rel_j)
    assert abs(len(gd_s.points) - len(gd_j.points)) < 0.15 * len(
        gd_j.points)


@pytest.mark.parametrize("gap", ["black", "noise"])
def test_streaming_track_loss_restart(rt_scene, tmp_path_factory, gap):
    """tests/test_runtime.py's test_streaming_track_loss_restart: a gap in
    the sequence mid-run.  Black frames fail the extraction gate and are
    never admitted; noise frames pass it and match nothing, so tracking is
    lost, the restart loop re-bootstraps with the carried pose and the
    device queue starts again from the host batch: the JAX package's
    schedule, cycle for cycle."""
    frames = [rt_scene.render(i) for i in range(7)]
    rng = np.random.default_rng(0)
    frames += ([np.zeros_like(frames[0])] * 3 if gap == "black" else
               [rng.integers(0, 256, frames[0].shape, dtype=np.uint8)
                for _ in range(7)])
    frames += [rt_scene.render(i) for i in range(7, 14)]
    out = tmp_path_factory.mktemp(gap)
    gd = tapp.slam_main(_cfg(tconfig, out, ba=False), rt_scene.K,
                        frames=frames, device="cpu")
    assert len(gd.rotations) >= 10
    assert len(gd.points) > 150
    if gap == "noise":
        cycles = (out / "main.txt").read_text().count("Launching main cycle")
        assert cycles == 2
        gd_j = japp.slam_main(_cfg(jconfig, tmp_path_factory.mktemp("j"),
                                   ba=False), rt_scene.K, frames=frames)
        assert _ids(gd) == _ids(gd_j)


def _host_engine(scene, frames, **over):
    cfg = EngineConfig(max_keypoints=256, ring=12, map_cap=2048, window=4,
                       window_points=2048, threshold=20.0,
                       required_matched=30, ransac_iters=128, pnp_iters=64,
                       ingest_mode="host", ingest_downscale=1,
                       host_desc="same", **over)
    return DeviceEngine(ArraySource(frames), scene.K, cfg, batch_size=6,
                        required_extracted=50, device="cpu")


def test_advance_stream_idle_steps_do_not_latch_dead(rt_scene):
    """tests/test_runtime.py's
    test_advance_stream_idle_steps_do_not_latch_dead: a call whose queue
    is below the visible floor (tail off) idles every step, comes back with
    dead off and nothing consumed and draws nothing; with the tail on the
    same call steps."""
    eng = _host_engine(rt_scene, [rt_scene.render(i) for i in range(4)])
    cfg = eng.cfg
    T = cfg.window
    queue = torch.zeros(cfg.ring, dtype=torch.long)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state().clone()
    (state, q_head, q_len, win_fill, dead, packed, ba_vec, _ox, _oc) = \
        tsteps.advance_stream(cfg, eng.state, queue, 0, 3, 0, False, gen, T,
                              visible=6, tail=False)
    assert not bool(dead), "idle steps must not latch dead"
    assert int(q_len) == 3 and int(q_head) == 0
    assert (packed[:, 0] < 0.5).all() and not packed.any()
    assert not ba_vec.any()
    assert torch.equal(gen.get_state(), before), "an idle step draws"
    (_s, _qh, _ql, _wf, _dead2, packed2, _b, _ox2, _oc2) = \
        tsteps.advance_stream(cfg, state, queue, q_head, 3, 0, False, gen,
                              T, visible=6, tail=True)
    assert packed2[0, 0] > 0.5, "a tail call must step"
    assert packed2.shape == (T, 24 + 6)


def test_window2_falls_back_to_classic_loop(rt_scene, rt_frames, tmp_path):
    """tests/test_runtime.py's test_window2_falls_back_to_classic_loop, under
    host ingest: window 2 must not stream (every step would idle behind a
    full window), and the classic loop completes with BA every 2 frames."""
    eng = _host_engine(rt_scene, [rt_scene.render(0)])
    assert eng._will_stream
    eng2 = DeviceEngine(
        ArraySource([rt_scene.render(0)]), rt_scene.K,
        EngineConfig(max_keypoints=256, window=2, ingest_mode="host",
                     host_desc="same", streaming=True),
        batch_size=4, required_extracted=50, device="cpu")
    assert not eng2._will_stream
    cfg = dataclasses.replace(_cfg(tconfig, tmp_path), BAMaxFramesCnt=2)
    gd = tapp.slam_main(cfg, rt_scene.K, frames=list(rt_frames),
                        device="cpu")
    assert len(gd.rotations) >= 10
    assert _rel_ate(rt_scene, gd) < 0.06


def test_adaptive_threshold_lowers_and_recovers(rt_scene):
    """tests/test_runtime.py's test_adaptive_threshold_lowers_and_recovers
    on the port, with the JAX engine's threshold beside it step for step."""
    import io

    class _Logs:
        def __init__(self):
            self.main = io.StringIO()

    def engines(adaptive):
        kw = dict(max_keypoints=256, threshold=20.0, ingest_mode="host",
                  host_desc="same", adaptive_threshold=adaptive)
        t = DeviceEngine(ArraySource([rt_scene.render(0)]), rt_scene.K,
                         EngineConfig(**kw), batch_size=4,
                         required_extracted=100, device="cpu")
        j = JEngine(JArraySource([rt_scene.render(0)]), rt_scene.K,
                    JEngineConfig(**kw), batch_size=4,
                    required_extracted=100)
        t.logs, j.logs = _Logs(), _Logs()
        return t, j

    eng, jeng = engines(True)
    chunks = ([[400, 380, 395]] + [[40, 35, 50]] * 12
              + [[900, 950, 880]] * 12)
    for c in chunks:
        eng._adapt_threshold(np.array(c))
        jeng._adapt_threshold(np.array(c))
        assert eng._fast_threshold == jeng._fast_threshold
    assert eng._fast_threshold == 20.0
    assert eng._fast_floor == jeng._fast_floor == 5.0
    assert eng.logs.main.getvalue() == jeng.logs.main.getvalue()
    assert "Adaptive FAST threshold: 20 -> 15" in eng.logs.main.getvalue()
    off, _ = engines(False)
    off._adapt_threshold(np.array([10, 10, 10]))
    assert off._fast_threshold == 20.0


@pytest.mark.parametrize("Q,q_head,q_len,admit", [
    (12, 0, 0, [1, 1, 0, 1, 0, 0, 1, 1]),
    (12, 9, 2, [1, 0, 1, 1, 1, 0, 1, 0]),      # wraps past the end
    (12, 5, 9, [1, 1, 1, 1, 1, 1, 1, 1]),      # overruns the head
    (8, 3, 4, [0, 0, 0, 0, 0, 0, 0, 0]),       # admits nothing
])
def test_queue_append_equals_jax(Q, q_head, q_len, admit):
    rng = np.random.default_rng(Q + q_head)
    queue = rng.integers(0, 40, Q).astype(np.int32)
    slots = rng.permutation(40)[:8].astype(np.int32)
    admit = np.asarray(admit, bool)
    jq, jl = jsteps.queue_append(jnp.asarray(queue), jnp.asarray(q_head),
                                 jnp.asarray(q_len), jnp.asarray(slots),
                                 jnp.asarray(admit))
    tq, tl = tsteps.queue_append(torch.from_numpy(queue.astype(np.int64)),
                                 torch.tensor(q_head), torch.tensor(q_len),
                                 torch.from_numpy(slots.astype(np.int64)),
                                 torch.from_numpy(admit))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert int(tl) == int(jl)


@pytest.mark.parametrize("ingest,descriptor,host_desc,want", [
    ("device", "sift", "auto", "same"),
    ("device", "sift", "hybrid", "same"),
    ("device", "orb", "orb", "same"),
    ("host", "sift", "same", "same"),
    ("host", "orb", "same", "same"),
    ("host", "sift", "auto", "hybrid"),
    ("host", "sift", "hybrid", "hybrid"),
    ("host", "sift", "orb", "orb"),
    ("host", "orb", "auto", "orb"),
    ("host", "orb", "hybrid", "orb"),
])
def test_host_desc_resolution_matches_jax(rt_scene, ingest, descriptor,
                                          host_desc, want):
    """The JAX engine's host-descriptor rules: the port resolves every case
    as the JAX engine does (descriptor source, metric, descriptor width and
    type) and ingests a chunk with it: every kept keypoint gets a
    descriptor."""
    kw = dict(max_keypoints=64, ring=8, map_cap=256, window=4,
              window_points=256, descriptor=descriptor,
              metric="hamming" if descriptor == "orb" else "l2",
              ingest_mode=ingest, host_desc=host_desc)
    jeng = JEngine(JArraySource([rt_scene.render(0)]), rt_scene.K,
                   JEngineConfig(**kw), batch_size=4, required_extracted=10)
    assert jeng.cfg.host_desc == want
    eng = DeviceEngine(ArraySource([rt_scene.render(0)]), rt_scene.K,
                       EngineConfig(**kw), batch_size=4,
                       required_extracted=10, device="cpu")
    assert eng.cfg.ingest_mode == ingest
    assert (eng.cfg.host_desc, eng.cfg.metric, eng.cfg.desc_dim) == (
        jeng.cfg.host_desc, jeng.cfg.metric, jeng.cfg.desc_dim)
    jdesc = np.asarray(jeng.state.ring_desc)
    assert tuple(eng.state.ring_desc.shape[1:]) == jdesc.shape[1:]
    assert eng.state.ring_desc.element_size() == jdesc.dtype.itemsize
    assert eng._stage_chunk() and eng._dispatch_ingest()
    slot = int(eng._pending[0][0][0])
    valid = eng.state.ring_valid[slot]
    desc = eng.state.ring_desc[slot]
    assert int(valid.sum()) > 20
    assert bool((desc[valid] != 0).any(-1).float().mean() > 0.9)


def test_link_probe_measures_once_per_device():
    """The bandwidth probe behind ingest="auto": a positive rate, measured
    once per process and device (the second call returns the first
    reading)."""
    from slam_indoor_code_tpu_torch.runtime.engine import (
        measured_link_bandwidth_mbps)

    bw = measured_link_bandwidth_mbps("cpu")
    assert bw > 0.0
    assert measured_link_bandwidth_mbps(torch.device("cpu")) == bw


def test_slam_main_refuses_the_default_host_descriptor(rt_scene, rt_frames,
                                                      tmp_path):
    """A host-ingest config left at host_descriptor "auto" runs the JAX
    package's hybrid descriptor (it no longer refuses it): the port's run
    of the first 8 frames resolves to "hybrid" and gives the JAX package's
    cameras, ATE within 0.02 of the extent of its ATE."""
    engines = []
    orig_init = DeviceEngine.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        engines.append(self)

    DeviceEngine.__init__ = init
    try:
        gd = tapp.slam_main(_cfg(tconfig, tmp_path / "t",
                                 host_descriptor="auto"),
                            rt_scene.K, frames=list(rt_frames[:8]),
                            device="cpu")
    finally:
        DeviceEngine.__init__ = orig_init
    assert (engines[0].cfg.host_desc, engines[0].cfg.desc_dim) == (
        "hybrid", 384)
    gd_j = japp.slam_main(_cfg(jconfig, tmp_path / "j",
                               host_descriptor="auto"),
                          rt_scene.K, frames=list(rt_frames[:8]))
    assert len(gd.rotations) >= 6
    assert _ids(gd) == _ids(gd_j)
    rel_t, rel_j = _rel_ate(rt_scene, gd), _rel_ate(rt_scene, gd_j)
    assert rel_t < 0.05 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)
