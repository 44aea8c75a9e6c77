"""The port's CLI (``python -m slam_indoor_code_tpu_torch <config.json>``)
on the CPU: twins of tests/test_cli.py run as real subprocesses with
``--device cpu`` — photo-glob media from disk, XML calibration,
reference-format outputs, the onlyViz reload, exit 2 on a config error or
a missing argument — and the port's own flag: ``--device`` defaults to
CUDA and raises without a GPU."""

import json
import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(scope="module")
def cli_workdir(tmp_path_factory):
    import cv2

    from slam_indoor_code_tpu.testing import make_scene
    from slam_indoor_code_tpu_torch.config import Config, TpuConfig, dump_config
    from slam_indoor_code_tpu_torch.io.xmlio import save_matrix_to_xml

    root = tmp_path_factory.mktemp("cli")
    scene = make_scene(n_points=700, n_frames=10, seed=5, baseline=0.3)
    photos = root / "photos"
    photos.mkdir()
    for i in range(10):
        cv2.imwrite(str(photos / f"frame_{i:03d}.png"),
                    cv2.cvtColor(scene.render(i), cv2.COLOR_RGB2BGR))
    calib = root / "cam.xml"
    save_matrix_to_xml(str(calib), scene.K, "K")
    out = root / "out"
    out.mkdir()
    cfg = Config(
        usePhotosCycle=True,
        photosPathPattern=str(photos / "*.png"),
        calibrationPath=str(calib),
        outputDataDir=str(out),
        requiredExtractedPointsCount=80,
        featureExtractingThreshold=20,
        framesBatchSize=6,
        requiredMatchedPointsCount=30,
        knnMatcherDistance=0.8,
        RPDistanceThreshold=500.0,
        useBundleAdjustment=True,
        BAMaxFramesCnt=8,
        BAUseHuberLossFunction=True,
        BAHuberLossFunctionParameter=2.0,
        tpu=TpuConfig(max_keypoints=512, ransac_iters=256,
                      pnp_ransac_iters=128, window_points=4096,
                      ba_max_iters=10),
    )
    cfg_path = root / "config.json"
    cfg_path.write_text(dump_config(cfg))
    return root, cfg_path, out, scene


def _run_cli(args, timeout=420):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "slam_indoor_code_tpu_torch", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=repo)


def test_cli_end_to_end_photos(cli_workdir):
    root, cfg_path, out, scene = cli_workdir
    r = _run_cli([str(cfg_path), "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "map points:" in r.stdout and "cameras:" in r.stdout
    for f in ("poses.txt", "rotations.txt", "points.txt", "colors.txt",
              "main.txt", "time.txt"):
        assert (out / f).stat().st_size > 0, f
    # the reference format reloads (the onlyViz contract)
    from slam_indoor_code_tpu_torch.io.logs import load_global_data_from_logs

    gd = load_global_data_from_logs(str(out))
    assert len(gd.rotations) == 10
    assert len(gd.points) > 150


def test_cli_only_viz_reload(cli_workdir):
    """onlyViz=true re-parses the previous run's logs instead of running
    SLAM (src/main.cpp:55-56); it needs no device."""
    root, cfg_path, out, scene = cli_workdir
    raw = json.loads(cfg_path.read_text())
    raw["onlyViz"] = True
    p2 = root / "config_viz.json"
    p2.write_text(json.dumps(raw))
    r = _run_cli([str(p2), "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "map points:" in r.stdout


def test_cli_bad_config_exit2(cli_workdir, tmp_path):
    root, cfg_path, out, scene = cli_workdir
    raw = json.loads(cfg_path.read_text())
    del raw["framesBatchSize"]
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(raw))
    r = _run_cli([str(p), "--device", "cpu"], timeout=120)
    assert r.returncode == 2
    assert "framesBatchSize" in r.stderr


def test_cli_missing_arg_exit2():
    r = _run_cli([], timeout=120)
    assert r.returncode == 2


@pytest.mark.parametrize("flags,message", [
    (["--device", "tpu"], "--device expects cpu or cuda"),
    (["--checkpoint-every", "many"], "--checkpoint-every expects an integer"),
])
def test_cli_bad_flag_exit2(cli_workdir, capsys, flags, message):
    from slam_indoor_code_tpu_torch import cli

    _, cfg_path, _, _ = cli_workdir
    assert cli.main([str(cfg_path), *flags]) == 2
    assert message in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "behaviour: without a GPU the default device raises")
def test_cli_device_defaults_to_cuda(cli_workdir):
    """Without ``--device`` the port runs on CUDA, and without a GPU it
    raises rather than fall back to the CPU."""
    from slam_indoor_code_tpu_torch import cli

    _, cfg_path, _, _ = cli_workdir
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main([str(cfg_path)])
