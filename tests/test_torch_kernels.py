"""The port's top-2 kernel: its plain PyTorch version against the Pallas
kernel (interpret mode) on the same numpy inputs, and the ctypes binding.
(The kernel itself against its plain version: tests/test_torch_gpu.py.)"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.ops.pallas_kernels import top2_pallas_batch
from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

BIG = np.float32(3e38)


def _l2_inputs(rng, B, N, M, D, masked=0.1):
    a = rng.normal(size=(N, D)).astype(np.float32)
    b = rng.normal(size=(B, M, D)).astype(np.float32)
    vb = rng.random((B, M)) >= masked
    return a, b, vb


def _both(a, b, vb, metric="l2"):
    ref = [np.asarray(x) for x in top2_pallas_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb), metric=metric,
        interpret=True)]
    ta = torch.from_numpy(a.view(np.int32) if metric == "hamming" else a)
    tb = torch.from_numpy(b.view(np.int32) if metric == "hamming" else b)
    got = [x.numpy() for x in ck.top2_batch(ta, tb, torch.from_numpy(vb),
                                            metric)]
    return ref, got


def _assert_l2_close(ref, got, a, b):
    """idx1 exact; d1/d2 to rtol 1e-5 plus an absolute 4e-7·(|a|²+|b|²)
    (about 3 float32 ulps of the largest norm sum: |a|²+|b|²−2a·b cancels,
    and the two sides sum the 128 products in different orders)."""
    (rd1, ri1, rd2), (gd1, gi1, gd2) = ref, got
    np.testing.assert_array_equal(gi1, ri1)
    atol = 4e-7 * float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max())
    np.testing.assert_allclose(gd1, rd1, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(gd2, rd2, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("B,N,M", [(3, 64, 200), (2, 37, 53), (1, 5, 1)])
def test_plain_matches_pallas_l2(B, N, M):
    rng = np.random.default_rng(1)
    a, b, vb = _l2_inputs(rng, B, N, M, 128)
    ref, got = _both(a, b, vb)
    _assert_l2_close(ref, got, a, b)


def test_plain_all_masked_lane_and_ties():
    rng = np.random.default_rng(2)
    a, b, vb = _l2_inputs(rng, 3, 64, 200, 128)
    vb[1] = False                      # a lane with every column masked
    b[0, 150] = b[0, 20]               # duplicate columns: a tie
    a[7] = b[0, 20]
    vb[0, [20, 150]] = True
    ref, got = _both(a, b, vb)
    _assert_l2_close(ref, got, a, b)
    gd1, gi1, gd2 = got
    assert np.all(gd1[1] == BIG) and np.all(gd2[1] == BIG)
    assert np.all(gi1[1] == 0)
    assert gi1[0, 7] == 20             # the lowest column wins the tie
    assert gd2[0, 7] == gd1[0, 7]      # a duplicate minimum is also d2


def test_plain_matches_pallas_hamming_exactly():
    rng = np.random.default_rng(3)
    B, N, M, W = 2, 32, 100, 8
    a = rng.integers(0, 2**32, (N, W), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (B, M, W), dtype=np.uint64).astype(np.uint32)
    vb = rng.random((B, M)) >= 0.1
    b[1, 60] = b[1, 4]
    a[0] = b[1, 4]
    ref, got = _both(a, b, vb, metric="hamming")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


def test_unpack_bits_little_endian():
    w = torch.tensor([[1, -2**31, 6]], dtype=torch.int32)
    bits = ck.unpack_bits(w)
    assert bits.shape == (1, 96) and bits.dtype == torch.bfloat16
    on = torch.nonzero(bits[0]).flatten().tolist()
    assert on == [0, 32 + 31, 64 + 1, 64 + 2]


_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.mark.parametrize("name,want", [
    ("top2_batch_launch", [_P] * 6 + [_I] * 5 + [_P]),
    ("top2_pair_launch", [_P] * 9 + [_I] * 5 + [_P]),
    ("top2_l1_launch", [_P] * 6 + [_I] * 4 + [_P]),
])
def test_ctypes_signature_takes_pointer_width_args(name, want):
    """Every pointer and the stream are c_void_p: a bare Python int would be
    passed as a 32-bit int and cut a device pointer."""

    def launch(*args):
        return 0

    proto = ctypes.CFUNCTYPE(ctypes.c_int)(launch)
    ck.set_signature(proto, name)
    assert list(proto.argtypes) == want
    assert proto.restype is ctypes.c_int


def test_cpu_wrapper_uses_plain_version_and_counts_nothing():
    rng = np.random.default_rng(4)
    a, b, vb = _l2_inputs(rng, 2, 16, 24, 128)
    before = ck.top2_batch.launches
    got = ck.top2_batch(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(vb))
    want = ck.top2_batch_plain(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(vb))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ck.top2_batch.launches == before
