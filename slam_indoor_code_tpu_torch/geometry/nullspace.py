"""The smallest eigenvector of batched symmetric matrices, the nullspace
that the DLT solvers (PnP's 6-point, the 8-point essential, two-view
triangulation) read off AᵀA.

On CUDA the eigensolver runs in float64.  cuSOLVER's batched Jacobi
``eigh`` in float32 leaves the smallest eigenpair of these near-singular
matrices far less accurate than LAPACK does on the CPU: on PnP-shaped
12x12 matrices its smallest eigenvectors part from LAPACK's on 83 % of
the batch (|cos| < 0.999, down to 0.002, on an H100; PERF.md §6), and
tracking on CUDA lost the textured two-plane scene of testing/realtex.py
(ATE 28.5 % against 0.12 % on the CPU).  The CPU keeps float32 LAPACK, so
CPU results are unchanged."""

from __future__ import annotations

import torch


def smallest_eigenvector(AtA: torch.Tensor) -> torch.Tensor:
    """[..., D, D] symmetric → the unit eigenvector of the smallest
    eigenvalue, [..., D], in AtA's dtype."""
    if AtA.is_cuda and AtA.dtype == torch.float32:
        _, vecs = torch.linalg.eigh(AtA.double())
        return vecs[..., 0].float()
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., 0]
