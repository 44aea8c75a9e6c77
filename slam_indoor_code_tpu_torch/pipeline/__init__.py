"""Incremental-SfM pipeline, the classic host conductor: batch scheduling,
main cycle, map arena (counterpart of the JAX package's pipeline/)."""

from .batch import EMPTY_BATCH, FRAME_NOT_FOUND, BatchScheduler
from .main_cycle import CycleSettings, MainCycle
from .structures import (
    BatchElement,
    MapArena,
    TemporalFrameData,
    harvest_pnp_correspondences,
    push_new_spatial_points,
)

__all__ = [
    "BatchElement",
    "BatchScheduler",
    "CycleSettings",
    "EMPTY_BATCH",
    "FRAME_NOT_FOUND",
    "MainCycle",
    "MapArena",
    "TemporalFrameData",
    "harvest_pnp_correspondences",
    "push_new_spatial_points",
]
