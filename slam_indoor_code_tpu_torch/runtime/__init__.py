"""Device-resident SLAM runtime (counterpart of the JAX package's runtime/):
all pipeline state on the device, advanced by fused step functions, with
the host reading one small status tensor per window."""

from .engine import DeviceEngine
from .state import EngineConfig, TrackerState, init_state, state_from_numpy

__all__ = ["DeviceEngine", "EngineConfig", "TrackerState", "init_state",
           "state_from_numpy"]
