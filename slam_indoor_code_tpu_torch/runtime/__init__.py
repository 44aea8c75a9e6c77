"""Device-resident SLAM runtime (counterpart of the JAX package's runtime/):
all pipeline state on the device, advanced by fused step functions, with
the host reading one small status tensor per window."""

from .checkpoint import checkpoint_next_fid, load_checkpoint, save_checkpoint
from .engine import DeviceEngine
from .state import EngineConfig, TrackerState, init_state, state_from_numpy

__all__ = ["DeviceEngine", "EngineConfig", "TrackerState",
           "checkpoint_next_fid", "init_state", "load_checkpoint",
           "save_checkpoint", "state_from_numpy"]
