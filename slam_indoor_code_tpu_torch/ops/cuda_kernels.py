"""CUDA kernels for the hot matching op: fused distance matrix + top-2.

Counterpart of the JAX package's ops/pallas_kernels.py.  ``top2_batch`` is
``top2_pallas_batch``: ONE query set [N,D] against B candidate sets [B,M,D]
in one launch of ``csrc/top2_batch.cu`` (sm_90a, built by ops/build.py and
bound through ctypes).  ``top2_batch_plain`` is the same function in plain
PyTorch: the CPU path, and the kernel's oracle on the card.

The wrapper takes the plain version only for a tensor on the CPU; on a CUDA
tensor it launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

BIG = 3.0e38
MAX_D = 256   # the kernel's shared-memory plan covers D <= 256 (bf16 SIFT
#               is 128; Hamming unpacks 8 words to 256 bits)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 bit words → [..., W*32] bf16 0/1, little-endian per
    word (as pallas_kernels._unpack_bits and ops.orb.pack_bits).  The words
    are an int32 view of the uint32 descriptors: torch has no uint32 ``>>``
    on the CPU, and an arithmetic shift leaves bit k intact after ``& 1``."""
    if words.dtype != torch.int32:
        raise TypeError(f"bit words must be int32, got {words.dtype}")
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.bfloat16)


def _operands(desc_a, desc_b, metric):
    if metric == "l2":
        return desc_a.to(torch.bfloat16), desc_b.to(torch.bfloat16)
    if metric == "hamming":
        return unpack_bits(desc_a), unpack_bits(desc_b)
    raise ValueError(f"top2 batch: unsupported metric {metric!r}")


def top2_batch_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
                     valid_b: torch.Tensor, metric: str = "l2"):
    """Plain PyTorch version of the kernel: (d1 [B,N] f32, idx1 [B,N] i32,
    d2 [B,N] f32).  Operands rounded to bf16 and upcast, f32 product and
    norms, masked columns at BIG, first-index argmin, d2 with only the
    argmin column masked."""
    a, b = _operands(desc_a, desc_b, metric)
    a, b = a.float(), b.float()
    ab = torch.matmul(a, b.transpose(1, 2))                  # [B,N,M]
    a2 = (a * a).sum(-1)                                     # [N]
    b2 = (b * b).sum(-1)                                     # [B,M]
    d = torch.clamp_min(a2[None, :, None] + b2[:, None, :] - 2.0 * ab, 0.0)
    d = torch.where(valid_b[:, None, :], d, torch.full_like(d, BIG))
    if d.shape[-1] == 0:
        B, N = d.shape[:2]
        full = torch.full((B, N), BIG, dtype=torch.float32, device=d.device)
        return full, torch.zeros((B, N), dtype=torch.int32,
                                 device=d.device), full.clone()
    idx1 = torch.argmin(d, dim=-1)                           # first minimum
    d1 = torch.gather(d, -1, idx1[..., None])[..., 0]
    d2 = d.scatter(-1, idx1[..., None], BIG).amin(-1)
    return d1, idx1.to(torch.int32), d2


def _lib():
    from . import build

    lib = build.load("top2_batch")
    if lib.top2_batch_launch.argtypes is None:
        set_signature(lib.top2_batch_launch)
    return lib


def set_signature(fn) -> None:
    """ctypes signature of ``top2_batch_launch``: every pointer and the
    stream as c_void_p (a bare Python int would be cut to 32 bits), sizes as
    c_int, cudaError_t returned as c_int."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int


def top2_batch(desc_a: torch.Tensor, desc_b: torch.Tensor,
               valid_b: torch.Tensor, metric: str = "l2"):
    """Fused 2-NN of desc_a [N,D] against desc_b [B,M,D] with column mask
    valid_b [B,M] → (d1 [B,N], idx1 [B,N] int32, d2 [B,N]).  Squared L2 on
    bf16-rounded operands; metric "hamming" takes int32 bit words [.., 8].

    A CPU tensor takes ``top2_batch_plain``; a CUDA tensor launches the
    kernel on the current stream (no synchronisation) and counts the
    launch in ``top2_batch.launches``."""
    dev = desc_a.device
    if dev.type == "cpu":
        return top2_batch_plain(desc_a, desc_b, valid_b, metric)
    if dev.type != "cuda":
        raise ValueError(f"top2_batch: unsupported device {dev}")
    if desc_b.device != dev or valid_b.device != dev:
        raise ValueError("top2_batch: all inputs must be on one device")
    if desc_a.dim() != 2 or desc_b.dim() != 3 or valid_b.dim() != 2:
        raise ValueError("top2_batch: expected desc_a [N,D], desc_b [B,M,D], "
                         "valid_b [B,M]")
    if valid_b.dtype != torch.bool:
        raise TypeError(f"valid_b must be bool, got {valid_b.dtype}")
    a, b = _operands(desc_a, desc_b, metric)
    a, b = a.contiguous(), b.contiguous()
    N, D = a.shape
    B, M, Db = b.shape
    if Db != D or tuple(valid_b.shape) != (B, M):
        raise ValueError(f"top2_batch: shape mismatch a {tuple(a.shape)} "
                         f"b {tuple(b.shape)} mask {tuple(valid_b.shape)}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"top2_batch: D={D} outside 1..{MAX_D}")
    mask = valid_b.contiguous().view(torch.uint8)
    d1 = torch.empty((B, N), dtype=torch.float32, device=dev)
    i1 = torch.empty((B, N), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().top2_batch_launch(
        a.data_ptr(), b.data_ptr(), mask.data_ptr(), d1.data_ptr(),
        i1.data_ptr(), d2.data_ptr(), N, M, D, B, stream)
    if err != 0:
        raise RuntimeError(f"top2_batch_launch failed: cudaError {err}")
    top2_batch.launches += 1
    return d1, i1, d2


top2_batch.launches = 0
