"""Tests that need a CUDA card: each kernel against its plain PyTorch
version on the card.  They skip without one.  No JAX here, so they also run
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)


def _l2_inputs(rng, B, N, M, D, masked=0.1):
    a = rng.normal(size=(N, D)).astype(np.float32)
    b = rng.normal(size=(B, M, D)).astype(np.float32)
    vb = rng.random((B, M)) >= masked
    return a, b, vb


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel has no CPU interpret mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,D", [(16, 2048, 2048, 128), (3, 1999, 1500,
                                                           128)])
def test_kernel_matches_plain_on_card(cuda_device, B, N, M, D):
    """idx1 equal wherever the plain version's top-2 gap exceeds
    1e-3·max(1, d1); d1/d2 to rtol 1e-4 plus 1e-6·(|a|²+|b|²) for the
    float32 cancellation (the two sum the products in different orders);
    an all-masked lane gives d1 = d2 = 3e38, idx1 = 0."""
    rng = np.random.default_rng(5)
    a, b, vb = _l2_inputs(rng, B, N, M, D)
    vb[-1] = False
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, b, vb)]
    before = ck.top2_batch.launches
    kd1, ki1, kd2 = (x.cpu().numpy() for x in ck.top2_batch(*args))
    assert ck.top2_batch.launches == before + 1
    pd1, pi1, pd2 = (x.cpu().numpy() for x in ck.top2_batch_plain(*args))
    # idx1 equal wherever the top-2 gap is clear of summation-order noise
    tol = 1e-3 * np.maximum(1.0, pd1)
    clear = (pd2 - pd1) > tol
    np.testing.assert_array_equal(ki1[clear], pi1[clear])
    atol = 1e-6 * float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max())
    np.testing.assert_allclose(kd1, pd1, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(kd2, pd2, rtol=1e-4, atol=atol)
    assert np.all(kd1[-1] == np.float32(3e38)) and np.all(ki1[-1] == 0)


@pytest.mark.gpu
def test_kernel_hamming_exact_on_card(cuda_device):
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (4, 257, 8), dtype=np.uint64).astype(np.uint32)
    vb = rng.random((4, 257)) >= 0.1
    args = [torch.from_numpy(a.view(np.int32)).to(cuda_device),
            torch.from_numpy(b.view(np.int32)).to(cuda_device),
            torch.from_numpy(vb).to(cuda_device)]
    got = ck.top2_batch(*args, metric="hamming")
    want = ck.top2_batch_plain(*args, metric="hamming")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
