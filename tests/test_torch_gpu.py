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


def _hold_l2(k, p, a, b):
    """The L2 rule of test_kernel_matches_plain_on_card."""
    kd1, ki1, kd2 = (x.cpu().numpy() for x in k)
    pd1, pi1, pd2 = (x.cpu().numpy() for x in p)
    tol = 1e-3 * np.maximum(1.0, pd1)
    clear = (pd2 - pd1) > tol
    np.testing.assert_array_equal(ki1[clear], pi1[clear])
    atol = 1e-6 * float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max())
    np.testing.assert_allclose(kd1, pd1, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(kd2, pd2, rtol=1e-4, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,D", [(4, 2048, 2048, 384), (2, 300, 500,
                                                          700)])
def test_kernel_takes_wide_descriptors_on_card(cuda_device, B, N, M, D):
    """D = 384 (the hybrid descriptor) keeps the query tile resident in
    shared memory; D = 700 is staged in chunks.  Same rule as above."""
    rng = np.random.default_rng(7)
    a, b, vb = _l2_inputs(rng, B, N, M, D)
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, b, vb)]
    _hold_l2(ck.top2_batch(*args), ck.top2_batch_plain(*args), a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 6])
@pytest.mark.parametrize("lpb", [2, 4])
def test_multi_lane_equals_single_lane_on_card(cuda_device, B, lpb):
    """lanes_per_block changes the schedule, not the result: exact."""
    rng = np.random.default_rng(8)
    a, b, vb = _l2_inputs(rng, B, 2048, 2048, 128)
    vb[-1] = False
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, b, vb)]
    before = ck.top2_batch.multi_lane_launches
    got = ck.top2_batch(*args, lanes_per_block=lpb)
    assert ck.top2_batch.multi_lane_launches == before + 1
    for g, w in zip(got, ck.top2_batch(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("N,M", [(2048, 2048), (1999, 1500)])
def test_pair_kernel_matches_plain_on_card(cuda_device, N, M):
    rng = np.random.default_rng(9)
    a, b, vb = _l2_inputs(rng, 1, N, M, 128)
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, b[0], vb[0])]
    before = ck.top2_pair.launches
    got = ck.top2_pair(*args)
    assert ck.top2_pair.launches == before + 1
    _hold_l2(got, ck.top2_pair_plain(*args), a, b)


@pytest.mark.gpu
def test_pair_kernel_hamming_exact_on_card(cuda_device):
    rng = np.random.default_rng(10)
    a = rng.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (257, 8), dtype=np.uint64).astype(np.uint32)
    vb = rng.random(257) >= 0.1
    args = [torch.from_numpy(a.view(np.int32)).to(cuda_device),
            torch.from_numpy(b.view(np.int32)).to(cuda_device),
            torch.from_numpy(vb).to(cuda_device)]
    got = ck.top2_pair(*args, metric="hamming")
    want = ck.top2_pair_plain(*args, metric="hamming")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,D", [(16, 2048, 2048, 128), (3, 1999, 1500,
                                                           32)])
def test_l1_kernel_matches_plain_on_card(cuda_device, B, N, M, D):
    """idx1 equal wherever the plain version's top-2 gap exceeds
    1e-5·max(1, d1); d1/d2 to rtol 1e-5 (both add |a_k − b_k| in k order);
    an all-masked lane gives d1 = d2 = 3e38, idx1 = 0; a duplicate column
    resolves to the lowest one with d2 == d1."""
    rng = np.random.default_rng(11)
    a, b, vb = _l2_inputs(rng, B, N, M, D)
    vb[-1] = False
    b[0, M // 2] = b[0, 3]
    a[0] = b[0, 3]
    vb[0, [3, M // 2]] = True
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, b, vb)]
    before = ck.top2_l1.launches
    kd1, ki1, kd2 = (x.cpu().numpy() for x in ck.top2_l1(*args))
    assert ck.top2_l1.launches == before + 1
    pd1, pi1, pd2 = (x.cpu().numpy() for x in ck.top2_l1_plain(*args))
    clear = (pd2 - pd1) > 1e-5 * np.maximum(1.0, pd1)
    np.testing.assert_array_equal(ki1[clear], pi1[clear])
    np.testing.assert_allclose(kd1, pd1, rtol=1e-5)
    np.testing.assert_allclose(kd2, pd2, rtol=1e-5)
    assert np.all(kd1[-1] == np.float32(3e38)) and np.all(ki1[-1] == 0)
    assert ki1[0, 0] == 3 and kd2[0, 0] == kd1[0, 0] == 0.0


@pytest.mark.gpu
def test_match_batch_l1_launches_the_kernel_on_card(cuda_device):
    from slam_indoor_code_tpu_torch.ops import knn

    rng = np.random.default_rng(12)
    a, b, vb = _l2_inputs(rng, 4, 256, 300, 128)
    a[:128] = b[0, :128] + 0.1 * rng.normal(size=(128, 128))
    ta, tb, tv = (torch.from_numpy(x).to(cuda_device) for x in (a, b, vb))
    va = torch.ones(256, dtype=torch.bool, device=cuda_device)
    fm = torch.ones(4, dtype=torch.bool, device=cuda_device)
    before = (ck.top2_l1.launches, ck.top2_batch.launches)
    got = knn.match_batch(ta, va, tb, tv, fm, 0.8, "l1")
    assert (ck.top2_l1.launches, ck.top2_batch.launches) == (
        before[0] + 1, before[1])
    want = knn.match_batch(ta.cpu(), va.cpu(), tb.cpu(), tv.cpu(), fm.cpu(),
                           0.8, "l1")
    # the CPU path sums |a − b| in another order: rows whose ratio margin is
    # inside rtol 1e-5 of d2 may go either way
    d1 = want["distance"].numpy()
    d2 = torch.stack([torch.topk(knn.l1_distance(ta.cpu(), tb[i].cpu())
                                 .masked_fill(~tv[i].cpu(), 3e38), 2,
                                 largest=False).values[:, 1]
                      for i in range(4)]).numpy()
    open_rows = np.abs(d1 - np.float32(0.8) * d2) <= 1e-5 * d2
    same = got["is_match"].cpu().numpy() == want["is_match"].numpy()
    assert np.all(same | open_rows)
    assert int(want["num_matches"][0]) > 50


@pytest.mark.gpu
@pytest.mark.parametrize("metric_case", ["batch", "pair"])
def test_hamming_exact_at_orb_shapes_on_card(cuda_device, metric_case):
    """ORB's shapes: 2048 × 2048 descriptors of 8 words (D = 256 bits
    unpacked), 16 candidate frames.  Sums of 0/1 products up to 256 are
    exact in f32, so the tensor-core tile equals the plain version."""
    rng = np.random.default_rng(13)
    a = rng.integers(0, 2**32, (2048, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (16, 2048, 8), dtype=np.uint64).astype(
        np.uint32)
    b[0, 1024] = b[0, 3]
    a[0] = b[0, 3]
    vb = rng.random((16, 2048)) >= 0.1
    vb[0, [3, 1024]] = True
    vb[5] = False
    ta = torch.from_numpy(a.view(np.int32)).to(cuda_device)
    tb = torch.from_numpy(b.view(np.int32)).to(cuda_device)
    tv = torch.from_numpy(vb).to(cuda_device)
    if metric_case == "pair":
        tb, tv = tb[0].contiguous(), tv[0].contiguous()
        got = ck.top2_pair(ta, tb, tv, metric="hamming")
        want = ck.top2_pair_plain(ta, tb, tv, metric="hamming")
    else:
        got = ck.top2_batch(ta, tb, tv, metric="hamming")
        want = ck.top2_batch_plain(ta, tb, tv, metric="hamming")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    d1, i1, d2 = (x.cpu().numpy().reshape(-1, 2048) for x in got)
    assert i1[0, 0] == 3 and d1[0, 0] == d2[0, 0] == 0.0
    if metric_case == "batch":
        assert np.all(d1[5] == np.float32(3e38)) and np.all(i1[5] == 0)


@pytest.mark.gpu
def test_segment_sum_repeats_bitwise_on_card(cuda_device):
    """The BA's normal-equation sums: 20 runs over ids with many repeats
    give the same bits (index_add_'s float atomics did not)."""
    from slam_indoor_code_tpu_torch.solver.ba import _segment_sum

    g = torch.Generator().manual_seed(14)
    ids = torch.randint(0, 50, (16384,), generator=g).to(cuda_device)
    ids[:4000] = 0                       # masked observations land on 0
    x = torch.randn(16384, 120, generator=g).to(cuda_device)
    x[:4000] = 0.0
    ref = _segment_sum(x, ids, 64)
    for _ in range(20):
        assert torch.equal(_segment_sum(x, ids, 64), ref)
    np.testing.assert_allclose(
        ref.cpu().numpy(), _segment_sum(x.cpu(), ids.cpu(), 64).numpy(),
        rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [None, 6])
def test_scatter_drop_repeats_bitwise_on_card(cuda_device, width):
    """Repeated and dropped indices: 20 runs give the same bits, and the
    CPU's (and JAX's) last-write-wins result."""
    from slam_indoor_code_tpu_torch.runtime.steps import _scatter_drop

    g = torch.Generator().manual_seed(15)
    n = 2048
    idx = torch.randint(0, n + 1, (n,), generator=g)
    idx[:1024] = torch.randint(0, 64, (1024,), generator=g)
    shape = (n,) if width is None else (n, width)
    val = torch.randn(shape, generator=g)
    base = torch.randn(shape, generator=g)
    want = _scatter_drop(base, idx, val)
    args = [t.to(cuda_device) for t in (base, idx, val)]
    ref = _scatter_drop(*args)
    for _ in range(20):
        assert torch.equal(_scatter_drop(*args), ref)
    assert torch.equal(ref.cpu(), want)
