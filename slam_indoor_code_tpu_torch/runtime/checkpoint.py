"""Mid-run checkpoint / resume of the device-resident tracker state
(counterpart of the JAX package's runtime/checkpoint.py, in its v5 layout
and under the same ``state_*`` / ``host_*`` / ``obs_*`` keys).

The full solver state (map arena, previous-frame features, pose, BA window,
intrinsics) and the host-side cursors round-trip through one compressed
npz, so a long run resumes exactly where it stopped.  Where the JAX package
saves its PRNG key (``host_key``), the port saves the engine generator's
state (``host_gen_state``).  The state is restored through
``state_from_numpy``, which is also how a snapshot written by the JAX
package is carried across (its uint32 bit words become the int32 view, its
int32 counters int64).
"""

from __future__ import annotations

import numpy as np
import torch

from .state import TrackerState, state_from_numpy


def _stack(rows, shape) -> np.ndarray:
    return np.stack(rows) if rows else np.zeros(shape)


def save_checkpoint(path: str, engine) -> None:
    """Snapshot a DeviceEngine (state + host cursors) to ``path`` (.npz)."""
    arrays = {f"state_{k}": v.cpu().numpy()
              for k, v in engine.state.tensors().items()}
    arrays["host_gen_state"] = engine.gen.get_state().numpy()
    arrays["host_win_fill"] = np.asarray(engine._win_fill)
    arrays["host_frames_accepted"] = np.asarray(engine.frames_accepted)
    arrays["host_traj_R"] = _stack(engine.trajectory_R, (0, 3, 3))
    arrays["host_traj_t"] = _stack(engine.trajectory_t, (0, 3))
    # media cursor: frames with source id ≤ prev_fid are fully consumed
    # (consumption is head-first in id order); everything after re-pulls
    # deterministically on resume, so `next_fid` is the media restart point
    arrays["host_prev_fid"] = np.asarray(engine._prev_fid)
    arrays["host_win_ids"] = np.asarray(engine._win_ids, np.int64)
    # v5: the live FAST threshold (constant under device ingest, kept so the
    # layout stays the JAX package's)
    arrays["host_fast_threshold"] = np.asarray(engine._fast_threshold)
    # v3: the flushed (post-BA) trajectory, so a resumed run re-emits the
    # full output trajectory, and each window's observations for the final
    # global BA, so it refines the same problem as an uninterrupted run
    arrays["host_flushed_R"] = _stack(engine.flushed_R, (0, 3, 3))
    arrays["host_flushed_t"] = _stack(engine.flushed_t, (0, 3))
    arrays["host_flushed_ids"] = np.asarray(engine.flushed_ids, np.int64)
    obs = engine.global_observations()
    arrays["obs_n"] = np.asarray(len(obs))
    for i, (xy, corr, ids) in enumerate(obs):
        arrays[f"obs_xy_{i}"] = xy
        arrays[f"obs_corr_{i}"] = corr
        arrays[f"obs_ids_{i}"] = np.asarray(ids, np.int64)
    np.savez_compressed(path, **arrays)


def checkpoint_next_fid(path: str) -> int:
    """Source frame index a resumed run restarts its media at (0 for a
    pre-v2 snapshot without media cursors)."""
    data = np.load(path)
    return int(data["host_prev_fid"]) + 1 if "host_prev_fid" in data else 0


def _fields_of(data, engine) -> dict[str, np.ndarray]:
    """Every TrackerState field from the snapshot, shape-checked against
    the engine's; fields a pre-v4/v5 snapshot lacks get fresh defaults."""
    from ..geometry.rotations import matrix_to_rodrigues

    cur = engine.state.tensors()
    fields = {}
    for k in cur:
        if f"state_{k}" in data:
            arr = data[f"state_{k}"]
            if tuple(arr.shape) != tuple(cur[k].shape):
                raise ValueError(
                    f"checkpoint field {k}: shape {arr.shape} != engine "
                    f"{tuple(cur[k].shape)} (EngineConfig mismatch)")
            fields[k] = arr
        elif k == "win_map_base":
            # pre-v4: BA freeze base at 0 (everything free)
            fields[k] = np.zeros((), np.int64)
        elif k == "step_ema":
            # pre-v5: 0 = unknown (the pose-jump gate re-seeds)
            fields[k] = np.zeros((), np.float32)
        elif k == "prev_anchor_xy":
            # pre-v4: track anchors re-seeded at the resume frame
            fields[k] = np.asarray(data["state_prev_xy"], np.float32)
        elif k == "prev_anchor_cam":
            R = torch.from_numpy(np.asarray(data["state_pose_R"], np.float32))
            t = np.asarray(data["state_pose_t"], np.float32)
            cam6 = np.concatenate([matrix_to_rodrigues(R).numpy(), t])
            fields[k] = np.broadcast_to(
                cam6, (data["state_prev_xy"].shape[0], 6)).copy()
        else:
            raise ValueError(f"checkpoint missing field {k} (snapshot too "
                             "old)")
    return fields


def load_checkpoint(path: str, engine) -> None:
    """Restore a DeviceEngine from a snapshot in place: one written by
    ``save_checkpoint`` or by the JAX package's.  The engine must have been
    built with the same EngineConfig (shapes are checked field by field)."""
    data = np.load(path)
    state = state_from_numpy(_fields_of(data, engine), engine.device)
    cur = engine.state.tensors()
    engine.state = TrackerState(**{
        k: v.to(cur[k].dtype) for k, v in state.tensors().items()})
    if "host_gen_state" in data:
        engine.gen.set_state(torch.from_numpy(data["host_gen_state"]))
    engine._win_fill = int(data["host_win_fill"])
    engine.frames_accepted = int(data["host_frames_accepted"])
    engine.trajectory_R = list(data["host_traj_R"])
    engine.trajectory_t = list(data["host_traj_t"])
    if "host_prev_fid" in data:            # v2 cursors
        engine._prev_fid = int(data["host_prev_fid"])
        engine._frame_counter = engine._prev_fid + 1
        engine._win_ids = [int(i) for i in data["host_win_ids"]]
    if "host_fast_threshold" in data:      # v5
        engine._fast_threshold = float(data["host_fast_threshold"])
    if "host_flushed_ids" in data:         # v3: flushed trajectory + obs
        engine.flushed_R = list(data["host_flushed_R"])
        engine.flushed_t = list(data["host_flushed_t"])
        engine.flushed_ids = [int(i) for i in data["host_flushed_ids"]]
        engine._global_obs = [
            (torch.from_numpy(data[f"obs_xy_{i}"]),
             torch.from_numpy(data[f"obs_corr_{i}"]),
             [int(j) for j in data[f"obs_ids_{i}"]])
            for i in range(int(data["obs_n"]))]
