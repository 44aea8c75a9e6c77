"""CUDA kernels for the hot matching op: fused distance matrix + top-2.

Counterparts of the JAX package's ops/pallas_kernels.py, each a hand-written
sm_90a kernel in ``csrc/`` (built by ops/build.py, bound through ctypes)
with its plain PyTorch version beside it:

- ``top2_batch`` is ``top2_pallas_batch``: ONE query set [N,D] against B
  candidate sets [B,M,D] in one launch (squared L2 or Hamming);
  ``lanes_per_block > 1`` is ``_l2_kernel_b_multi``.
- ``top2_pair`` is ``top2_pallas`` for L2 and Hamming (``_l2_kernel``): one
  pair, its column axis split across blocks.
- ``top2_l1`` is ``top2_pallas(metric="l1")`` (``_l1_kernel``) over Bt pairs
  that share the query set, as ``match_batch`` vmaps it on the TPU.

The plain versions are the CPU path and the kernels' oracles on the card.
A wrapper takes its plain version only for a tensor on the CPU; on a CUDA
tensor it launches the kernel or raises — there is no fallback.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

BIG = 3.0e38
_P, _I = ctypes.c_void_p, ctypes.c_int

# ctypes signatures of the C entry points: every pointer and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as c_int,
# cudaError_t returned as c_int.
SIGNATURES = {
    # a, b, mask, d1, i1, d2, N, M, D, B, lanes_per_block, stream
    "top2_batch_launch": [_P] * 6 + [_I] * 5 + [_P],
    # a, b, mask, d1, i1, d2, pd1, pi1, pd2, N, M, D, S, cols_per_split, stream
    "top2_pair_launch": [_P] * 9 + [_I] * 5 + [_P],
    # a, b, mask, d1, i1, d2, N, M, D, Bt, stream
    "top2_l1_launch": [_P] * 6 + [_I] * 4 + [_P],
}

PAIR_ROWS = 128      # query rows per block of top2_pair (csrc/top2_l2.cuh)
PAIR_COLS = 128      # its column tile: a split is a multiple of it


def set_signature(fn, name: str) -> None:
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int


def _entry(stem: str):
    """The C entry point ``<stem>_launch`` of ``csrc/<stem>.cu`` (built on
    first use)."""
    from . import build

    name = f"{stem}_launch"
    fn = getattr(build.load(stem), name)
    if fn.argtypes is None:
        set_signature(fn, name)
    return fn


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
    raise ValueError(f"top2: unsupported metric {metric!r}")


def _masked_top2(d: torch.Tensor, valid: torch.Tensor):
    """[B,N,M] distances, [B,M] column mask → (d1, idx1 int32, d2) [B,N]:
    masked columns at BIG, first-index argmin, d2 with only the argmin
    column masked; no columns gives d1 = d2 = BIG, idx1 = 0."""
    B, N, M = d.shape
    if M == 0:
        full = torch.full((B, N), BIG, dtype=torch.float32, device=d.device)
        return full, torch.zeros((B, N), dtype=torch.int32,
                                 device=d.device), full.clone()
    d = torch.where(valid[:, None, :], d, torch.full_like(d, BIG))
    idx1 = torch.argmin(d, dim=-1)                           # first minimum
    d1 = torch.gather(d, -1, idx1[..., None])[..., 0]
    d2 = d.scatter(-1, idx1[..., None], BIG).amin(-1)
    return d1, idx1.to(torch.int32), d2


def _check_lpb(lanes_per_block: int) -> int:
    lpb = int(lanes_per_block)
    if lpb < 1:
        raise ValueError(f"lanes_per_block must be >= 1, got {lpb}")
    return lpb


def top2_batch_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
                     valid_b: torch.Tensor, metric: str = "l2",
                     lanes_per_block: int = 1):
    """Plain PyTorch version of ``top2_batch``: (d1 [B,N] f32, idx1 [B,N]
    i32, d2 [B,N] f32).  Operands rounded to bf16 and upcast, f32 product
    and norms.  ``lanes_per_block`` changes how the kernel schedules lanes,
    not what it computes, so it is only checked here."""
    _check_lpb(lanes_per_block)
    a, b = _operands(desc_a, desc_b, metric)
    a, b = a.float(), b.float()
    ab = torch.matmul(a, b.transpose(1, 2))                  # [B,N,M]
    a2 = (a * a).sum(-1)                                     # [N]
    b2 = (b * b).sum(-1)                                     # [B,M]
    d = torch.clamp_min(a2[None, :, None] + b2[:, None, :] - 2.0 * ab, 0.0)
    return _masked_top2(d, valid_b)


def top2_pair_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
                    valid_b: torch.Tensor, metric: str = "l2"):
    """Plain PyTorch version of ``top2_pair``: ``top2_batch_plain`` on one
    candidate set → (d1 [N], idx1 [N] i32, d2 [N])."""
    return tuple(x[0] for x in top2_batch_plain(desc_a, desc_b[None],
                                                valid_b[None], metric))


def top2_l1_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
                  valid_b: torch.Tensor):
    """Plain PyTorch version of ``top2_l1``: (d1 [Bt,N], idx1 [Bt,N] i32,
    d2 [Bt,N]).  f32 |a_k − b_k| added over k = 0..D−1 in order, the TPU
    kernel's arithmetic, so it equals the kernel bit for bit."""
    a, b = desc_a.float(), desc_b.float()
    d = torch.zeros((b.shape[0], a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    for k in range(a.shape[1]):
        d.add_((a[None, :, None, k] - b[:, None, :, k]).abs())
    return _masked_top2(d, valid_b)


def _check_inputs(name, dev, desc_a, desc_b, valid_b, b_dims):
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if desc_b.device != dev or valid_b.device != dev:
        raise ValueError(f"{name}: all inputs must be on one device")
    if desc_a.dim() != 2 or desc_b.dim() != b_dims or \
            valid_b.dim() != b_dims - 1:
        raise ValueError(f"{name}: expected desc_a [N,D], desc_b with "
                         f"{b_dims} dims and its column mask")
    if valid_b.dtype != torch.bool:
        raise TypeError(f"valid_b must be bool, got {valid_b.dtype}")
    if desc_a.shape[-1] != desc_b.shape[-1] or \
            tuple(valid_b.shape) != tuple(desc_b.shape[:-1]):
        raise ValueError(f"{name}: shape mismatch a {tuple(desc_a.shape)} "
                         f"b {tuple(desc_b.shape)} "
                         f"mask {tuple(valid_b.shape)}")
    if desc_a.shape[-1] < 1:
        raise ValueError(f"{name}: descriptors must have D >= 1")


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def top2_batch(desc_a: torch.Tensor, desc_b: torch.Tensor,
               valid_b: torch.Tensor, metric: str = "l2",
               lanes_per_block: int = 1):
    """Fused 2-NN of desc_a [N,D] against desc_b [B,M,D] with column mask
    valid_b [B,M] → (d1 [B,N], idx1 [B,N] int32, d2 [B,N]).  Squared L2 on
    bf16-rounded operands, any D; metric "hamming" takes int32 bit words.
    ``lanes_per_block`` lanes share one block's staged query tile (the
    result does not depend on it).

    A CPU tensor takes ``top2_batch_plain``; a CUDA tensor launches the
    kernel on the current stream (no synchronisation) and counts the launch
    in ``top2_batch.launches`` (and, with lanes_per_block > 1, in
    ``top2_batch.multi_lane_launches``; with metric "hamming", in
    ``top2_batch.hamming_launches``)."""
    lpb = _check_lpb(lanes_per_block)
    dev = desc_a.device
    if dev.type == "cpu":
        return top2_batch_plain(desc_a, desc_b, valid_b, metric, lpb)
    _check_inputs("top2_batch", dev, desc_a, desc_b, valid_b, 3)
    a, b = _operands(desc_a, desc_b, metric)
    a, b = a.contiguous(), b.contiguous()
    N, D = a.shape
    B, M, _ = b.shape
    mask = valid_b.contiguous().view(torch.uint8)
    d1 = torch.empty((B, N), dtype=torch.float32, device=dev)
    i1 = torch.empty((B, N), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, N), dtype=torch.float32, device=dev)
    _launch("top2_batch_launch", _entry("top2_batch"),
            a.data_ptr(), b.data_ptr(), mask.data_ptr(), d1.data_ptr(),
            i1.data_ptr(), d2.data_ptr(), N, M, D, B, lpb,
            torch.cuda.current_stream(dev).cuda_stream)
    top2_batch.launches += 1
    if lpb > 1:
        top2_batch.multi_lane_launches += 1
    if metric == "hamming":
        top2_batch.hamming_launches += 1
    return d1, i1, d2


top2_batch.launches = 0
top2_batch.multi_lane_launches = 0
top2_batch.hamming_launches = 0


def pair_splits(N: int, M: int, sms: int) -> tuple[int, int]:
    """(S, cols_per_split) for ``top2_pair``: about one block per SM over
    the row tiles × column ranges, each range a multiple of the 128-column
    tile, S ranges covering all M columns.  2048 × 2048 on 132 SMs gives 8
    ranges of two tiles (128 blocks)."""
    row_tiles = -(-max(N, 1) // PAIR_ROWS)
    want = max(1, -(-sms // row_tiles))
    per = -(-max(M, 1) // want)
    per = -(-per // PAIR_COLS) * PAIR_COLS
    return -(-max(M, 1) // per), per


def top2_pair(desc_a: torch.Tensor, desc_b: torch.Tensor,
              valid_b: torch.Tensor, metric: str = "l2"):
    """Fused 2-NN of desc_a [N,D] against one candidate set desc_b [M,D]
    with column mask valid_b [M] → (d1 [N], idx1 [N] int32, d2 [N]); the
    function of ``top2_batch`` at B = 1, with the column axis split across
    blocks so one pair fills the card.

    A CPU tensor takes ``top2_pair_plain``; a CUDA tensor launches the
    kernel's two passes on the current stream and counts one launch in
    ``top2_pair.launches``."""
    dev = desc_a.device
    if dev.type == "cpu":
        return top2_pair_plain(desc_a, desc_b, valid_b, metric)
    _check_inputs("top2_pair", dev, desc_a, desc_b, valid_b, 2)
    a, b = _operands(desc_a, desc_b, metric)
    a, b = a.contiguous(), b.contiguous()
    N, D = a.shape
    M = b.shape[0]
    S, per = pair_splits(
        N, M, torch.cuda.get_device_properties(dev).multi_processor_count)
    mask = valid_b.contiguous().view(torch.uint8)
    out = [torch.empty(n, dtype=t, device=dev) for n in (N, S * N)
           for t in (torch.float32, torch.int32, torch.float32)]
    _launch("top2_pair_launch", _entry("top2_pair"),
            a.data_ptr(), b.data_ptr(), mask.data_ptr(),
            *(x.data_ptr() for x in out), N, M, D, S, per,
            torch.cuda.current_stream(dev).cuda_stream)
    top2_pair.launches += 1
    return out[0], out[1], out[2]


top2_pair.launches = 0


def top2_l1(desc_a: torch.Tensor, desc_b: torch.Tensor,
            valid_b: torch.Tensor):
    """Fused L1 2-NN of desc_a [N,D] against Bt candidate sets desc_b
    [Bt,M,D] with column mask valid_b [Bt,M] → (d1 [Bt,N], idx1 [Bt,N]
    int32, d2 [Bt,N]); f32 operands, any D.

    A CPU tensor takes ``top2_l1_plain``; a CUDA tensor launches the kernel
    on the current stream (no synchronisation) and counts the launch in
    ``top2_l1.launches``."""
    dev = desc_a.device
    if dev.type == "cpu":
        return top2_l1_plain(desc_a, desc_b, valid_b)
    _check_inputs("top2_l1", dev, desc_a, desc_b, valid_b, 3)
    a = desc_a.float().contiguous()
    b = desc_b.float().contiguous()
    N, D = a.shape
    Bt, M, _ = b.shape
    mask = valid_b.contiguous().view(torch.uint8)
    d1 = torch.empty((Bt, N), dtype=torch.float32, device=dev)
    i1 = torch.empty((Bt, N), dtype=torch.int32, device=dev)
    d2 = torch.empty((Bt, N), dtype=torch.float32, device=dev)
    _launch("top2_l1_launch", _entry("top2_l1"),
            a.data_ptr(), b.data_ptr(), mask.data_ptr(), d1.data_ptr(),
            i1.data_ptr(), d2.data_ptr(), N, M, D, Bt,
            torch.cuda.current_stream(dev).cuda_stream)
    top2_l1.launches += 1
    return d1, i1, d2


top2_l1.launches = 0
