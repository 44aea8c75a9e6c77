"""slam_indoor_code_tpu_torch — the PyTorch/CUDA port of slam_indoor_code_tpu.

Same module layout and names as the JAX package, so each function has an
obvious counterpart there; inside, plain PyTorch functions on tensors with an
explicit ``torch.device`` and explicit ``torch.Generator``s.  Each TPU
kernel (the fused top-2 matchers) is a hand-written CUDA kernel for sm_90a
(``csrc/top2_batch.cu``, ``top2_pair.cu``, ``top2_l1.cu``), built with
plain ``nvcc`` on first use and bound through ``ctypes``
(``ops/cuda_kernels.py``).

Entry points take ``device=None``, which means CUDA; without a GPU they
raise rather than fall back to the CPU.  Tests pass ``device="cpu"``, where
every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

import torch as _torch

# Multiview geometry needs full float32 (SVD/eigh nullspaces, pose chains):
# the JAX package pins "highest" matmul precision for the same reason.  Only
# the descriptor kernel rounds to bf16, explicitly, as the Pallas kernel does.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> _torch.device:
    """``None`` → CUDA.  Raises when CUDA is asked for and absent: the port
    never falls back to the CPU silently."""
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "slam_indoor_code_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False (pass device='cpu' to run "
            "the plain PyTorch path)")
    return dev
