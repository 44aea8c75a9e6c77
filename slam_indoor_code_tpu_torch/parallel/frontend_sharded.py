"""The frontend's candidate-frame fan-out over a mesh (counterpart of the
JAX package's parallel/frontend_sharded.py).

Each shard extracts, describes and matches its block of the B candidate
frames on its own device; the previous frame's descriptors are copied to
every shard.  Matching is exact per candidate, so the split changes no
match: ``match_against_batch`` launches ``top2_batch`` once per shard on
CUDA and gives the unsplit call's counts.  The per-frame results are
gathered onto the first device in shard order (``mesh.map_batch``).
"""

from __future__ import annotations

import torch

from ..models import frontend as fe
from .mesh import Mesh, map_batch


class ShardedFrontend:
    """The frontend's batch programs with their batch axis split over a
    mesh."""

    def __init__(self, mesh: Mesh, fcfg: fe.FrontendConfig):
        self.mesh = mesh
        self.fcfg = fcfg
        self.devices_per_batch = mesh.size

    def pad_to_devices(self, b: int) -> int:
        n = self.devices_per_batch
        return -(-b // n) * n

    def extract_and_describe_batch(self, rgb_batch: torch.Tensor):
        """[B,H,W,3] u8 → the per-frame dict of
        ``frontend.extract_and_describe_batch``, each shard's frames
        extracted on its device."""
        return map_batch(self.mesh, lambda rgb: fe.extract_and_describe_batch(
            self.fcfg, rgb), (rgb_batch,))

    def match_against_batch(self, desc_prev, valid_prev, desc_batch,
                            valid_batch, frame_mask):
        """The previous frame against B candidates, one shard of them per
        device: one ``top2_batch`` launch per shard on CUDA."""
        return map_batch(
            self.mesh, lambda dp, vp, db, vb, fm: fe.match_against_batch(
                self.fcfg, dp, vp, db, vb, fm),
            (desc_batch, valid_batch, frame_mask), (desc_prev, valid_prev))
