"""``torch.func.jacfwd`` behind one process-wide lock.

Forward-mode AD keeps its dual level in process-global state
(``torch.autograd.forward_ad``'s current level, and a level list that must
be left in the order it was entered), so two threads taking Jacobians at
once break each other's.  ``app.run_sequences_parallel`` tracks sequences
on threads, so every Jacobian of the port (the PnP refine, the windowed BA,
the calibration) is taken through ``jacfwd`` here, one at a time.  On CUDA
the lock is held only while the Jacobian's kernels are enqueued.
"""

from __future__ import annotations

import threading

import torch.func

_LOCK = threading.RLock()


def jacfwd(fn, *args, **kwargs):
    """``torch.func.jacfwd(fn, ...)`` whose calls hold the lock."""
    jac = torch.func.jacfwd(fn, *args, **kwargs)

    def locked(*a, **kw):
        with _LOCK:
            return jac(*a, **kw)

    return locked
