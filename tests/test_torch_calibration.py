"""The port's OpenCV-XML calibration files and distortion coefficients
against the JAX package's, on the CPU: io/xmlio.py reads and writes the same
matrices, and ``useUndistortion`` carries the XML's DC from
``run_from_config`` into the engine, whose ingest then undistorts the
keypoints as the JAX package's does."""

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io import xmlio as jxml
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io import xmlio as txml
from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig
from slam_indoor_code_tpu_torch.runtime import steps as tsteps

torch.set_num_threads(1)

K_CAM = np.array([[1700.0, 0, 920.0], [0, 1710.0, 500.0], [0, 0, 1]])
DC = np.array([[-0.02, 1.36, -0.002, -0.004, -7.7]])


def _write_calib(mod, path, K, dc):
    mod.save_calib_parameters_to_xml(path, K, dc, np.arange(9.0).reshape(3, 3),
                                     np.ones((3, 3)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_xml_roundtrip_matches_jax(tmp_path, writer):
    """A file written by either package reads back the same K, DC, R and T
    in both."""
    path = str(tmp_path / "cam.xml")
    _write_calib(jxml if writer == "jax" else txml, path, K_CAM, DC)
    for key, want in (("K", K_CAM), ("DC", DC),
                      ("R", np.arange(9.0).reshape(3, 3)),
                      ("T", np.ones((3, 3)))):
        got = txml.load_matrix_from_xml(path, key)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jxml.load_matrix_from_xml(path, key))
    with open(path) as f:
        text = f.read()
    other = str(tmp_path / "other.xml")
    _write_calib(txml if writer == "jax" else jxml, other, K_CAM, DC)
    with open(other) as f:
        assert f.read() == text            # byte-identical files


def test_xml_append_and_missing_key(tmp_path):
    path = str(tmp_path / "k.xml")
    txml.save_matrix_to_xml(path, K_CAM, "K")
    txml.save_matrix_to_xml(path, DC, "DC", mode="a")
    np.testing.assert_array_equal(txml.load_matrix_from_xml(path, "DC"), DC)
    with pytest.raises(KeyError):
        txml.load_matrix_from_xml(path, "T")


def test_load_calibration_matches_jax(tmp_path):
    path = str(tmp_path / "cam.xml")
    _write_calib(txml, path, K_CAM, DC)
    tcfg = tconfig.Config(calibrationPath=path, useUndistortion=True)
    jcfg = jconfig.Config(calibrationPath=path, useUndistortion=True)
    for got, want in zip(tapp.load_calibration(tcfg),
                         japp.load_calibration(jcfg)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tapp._load_dist(tcfg), japp._load_dist(jcfg))
    # no DC in the file: zeros from load_calibration, None for the engine
    txml.save_matrix_to_xml(path, K_CAM, "K")
    tcfg = tconfig.Config(calibrationPath=path, useUndistortion=True)
    np.testing.assert_array_equal(tapp.load_calibration(tcfg)[1], np.zeros(5))
    assert tapp._load_dist(tcfg) is None
    off = tconfig.Config(calibrationPath=path, useUndistortion=False)
    assert tapp._load_dist(off) is None


@pytest.fixture(scope="module")
def ud_scene():
    # tests/test_runtime.py's rt_scene
    return make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)


def _engine_from_run(tmp_path, scene, frames, dc, name):
    """run_from_config on the port with K (and DC, when given) read from an
    XML: returns the engine it built and ran."""
    path = str(tmp_path / f"{name}.xml")
    txml.save_matrix_to_xml(path, scene.K, "K")
    if dc is not None:
        txml.save_matrix_to_xml(path, np.asarray(dc)[None], "DC", mode="a")
    cfg = tconfig.Config(
        usePhotosCycle=True, outputDataDir=str(tmp_path / name),
        calibrationPath=path, useUndistortion=True,
        requiredExtractedPointsCount=10, framesBatchSize=4, BAMaxFramesCnt=4,
        tpu=tconfig.TpuConfig(max_keypoints=256, window_points=256,
                              ingest="device"))
    engines = []
    orig = DeviceEngine.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        engines.append(self)

    DeviceEngine.__init__ = spy
    try:
        tapp.run_from_config(cfg, frames=frames, device="cpu")
    finally:
        DeviceEngine.__init__ = orig
    assert len(engines) == 1
    return engines[0]


def test_undistortion_from_xml_matches_jax(ud_scene, tmp_path):
    """Twin of tests/test_runtime.py::test_engine_undistortion_applied,
    through the port's run_from_config: the XML's DC reaches the engine's
    state, and its ingest puts the keypoints where the JAX package's does
    (within 1e-3 px), more than 1 px away from a zero-DC run's."""
    import jax.numpy as jnp

    from slam_indoor_code_tpu.io.media import ArraySource as JArraySource
    from slam_indoor_code_tpu.models.frontend import pack_frames
    from slam_indoor_code_tpu.runtime import DeviceEngine as JEngine
    from slam_indoor_code_tpu.runtime import EngineConfig as JEngineConfig
    from slam_indoor_code_tpu.runtime import steps as jsteps

    dist = np.array([0.15, -0.05, 0.0, 0.0, 0.0])
    frames = [ud_scene.render(0)]
    eng = _engine_from_run(tmp_path, ud_scene, frames, dist, "dc")
    assert eng.cfg.use_undistortion
    np.testing.assert_array_equal(eng.state.dist.numpy(),
                                  dist.astype(np.float32))
    eng0 = _engine_from_run(tmp_path, ud_scene, frames, None, "nodc")
    assert not eng0.state.dist.any()

    gray, small = pack_frames(frames * 8, eng.cfg.color_downscale)
    slots = np.arange(8)
    xy = {}
    for key, e in (("dc", eng), ("zero", eng0)):
        state, _ = tsteps.ingest(e.cfg, e.state, torch.from_numpy(gray),
                                 torch.from_numpy(small),
                                 torch.from_numpy(slots))
        xy[key] = state.ring_xy[0].numpy()
        valid = state.ring_valid[0].numpy()

    jcfg = JEngineConfig(max_keypoints=256, ring=9, map_cap=1024, window=4,
                         window_points=256, use_undistortion=True)
    je = JEngine(JArraySource(frames), ud_scene.K, jcfg, batch_size=4,
                 required_extracted=10, dist=dist)
    je.state, _ = jsteps.ingest(jcfg, je.state, jnp.asarray(gray),
                                jnp.asarray(small),
                                jnp.asarray(slots, jnp.int32))
    jxy = np.asarray(je.state.ring_xy[0])
    np.testing.assert_array_equal(valid, np.asarray(je.state.ring_valid[0]))
    assert valid.sum() > 50
    np.testing.assert_allclose(xy["dc"][valid], jxy[valid], atol=1e-3, rtol=0)
    assert np.abs(xy["dc"][valid] - xy["zero"][valid]).max() > 1.0
