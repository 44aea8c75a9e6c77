"""The port's multi-process runs on the CPU: twins of tests/test_parallel.py's
two-process tests, each running two processes of the port's worker
(``python -m slam_indoor_code_tpu_torch.parallel.worker``) joined by gloo
over a local TCP coordinator, with the JAX tests' per-process timeouts.

``init`` sums one row per process across the group; ``ba`` solves
``ShardedBA`` with its reduced camera system summed across the two
processes and holds it to a one-process solve (final cost within 1e-3
relative, cameras within 5e-4); ``pipeline`` runs ``slam_main`` on a mesh
of one shard per process and holds it to a run without a mesh (same frame
ids, trajectories within 3 % of the extent).
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_pair(mode: str, timeout: int) -> list[str]:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slam_indoor_code_tpu_torch.parallel.worker",
         mode, f"127.0.0.1:{port}", "2", str(i), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        cwd=REPO) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2500:]}"
    return outs


def test_two_process_distributed_initialize():
    """Twin of test_parallel.py::test_two_process_distributed_initialize."""
    for out in _run_pair("init", 240):
        assert "(gloo, cpu): global psum 24.0 OK" in out, out[-2000:]


def test_two_process_sharded_ba_solve():
    """Twin of test_parallel.py::test_two_process_sharded_ba_solve."""
    for out in _run_pair("ba", 300):
        assert "cross-process BA cost" in out and "OK" in out, out[-2000:]


def test_two_process_pipeline():
    """Twin of test_parallel.py::test_two_process_pipeline."""
    for out in _run_pair("pipeline", 700):
        assert "two-process pipeline cameras" in out and "OK" in out, \
            out[-2500:]


def test_worker_needs_two_processes():
    res = subprocess.run(
        [sys.executable, "-m", "slam_indoor_code_tpu_torch.parallel.worker",
         "init", "127.0.0.1:1", "1", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 2 and "nproc >= 2" in res.stderr


def test_single_process_initialize_is_a_noop():
    import torch.distributed as dist

    from slam_indoor_code_tpu_torch.parallel import initialize_distributed

    assert initialize_distributed("127.0.0.1:1", 1, 0, device="cpu") is None
    assert initialize_distributed() is None
    assert not dist.is_initialized()
