"""The port's per-pair top-2 (L2/Hamming), L1 top-2 and multi-lane batched
top-2: their plain PyTorch versions against the Pallas kernels (interpret
mode) on the same numpy inputs, and the port's ``knn.match_pair`` /
``match_batch(metric="l1")`` against the JAX package's on the CPU.  (The
kernels themselves against their plain versions: tests/test_torch_gpu.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.ops import knn as jknn
from slam_indoor_code_tpu.ops.pallas_kernels import (top2_pallas,
                                                      top2_pallas_batch)
from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck
from slam_indoor_code_tpu_torch.ops import knn as tknn

torch.set_num_threads(1)

BIG = np.float32(3e38)


def _pallas_pair(a, b, vb, metric):
    return [np.asarray(x) for x in top2_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb), metric=metric,
        interpret=True)]


def _bits(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("N,M,D,masked", [(100, 300, 128, 0.1),
                                          (32, 64, 16, 0.9), (7, 1, 128, 0.0)])
def test_pair_plain_matches_pallas_l2(N, M, D, masked):
    """idx1 exact; d1/d2 to rtol 1e-4 plus 4e-7·(|a|²+|b|²): bf16 operands,
    f32 sums taken in another order, and |a|²+|b|²−2a·b cancels (a duplicate
    row gives 0 on one side and ~1e-4 on the other)."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(N, D)).astype(np.float32)
    b = rng.normal(size=(M, D)).astype(np.float32)
    vb = rng.random(M) >= masked
    vb[0] = True
    b[M // 2] = b[0]                  # a duplicate column: a tie
    a[0] = b[0]
    ref = _pallas_pair(a, b, vb, "l2")
    got = [x.numpy() for x in ck.top2_pair_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(vb))]
    np.testing.assert_array_equal(got[1], ref[1])
    atol = 4e-7 * float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max())
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=atol)
    assert got[1][0] == 0             # the lowest column wins the tie


@pytest.mark.parametrize("N,M", [(64, 200), (300, 257)])
def test_pair_plain_matches_pallas_hamming_exactly(N, M):
    rng = np.random.default_rng(12)
    a, b = _bits(rng, N, 8), _bits(rng, M, 8)
    vb = rng.random(M) >= 0.1
    b[M - 1] = b[3]
    a[0] = b[3]
    ref = _pallas_pair(a, b, vb, "hamming")
    got = ck.top2_pair_plain(torch.from_numpy(a.view(np.int32)),
                             torch.from_numpy(b.view(np.int32)),
                             torch.from_numpy(vb), metric="hamming")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), r)


def _l1_case(rng, Bt, N, M, D):
    a = rng.normal(size=(N, D)).astype(np.float32)
    b = rng.normal(size=(Bt, M, D)).astype(np.float32)
    vb = rng.random((Bt, M)) >= 0.1
    return a, b, vb


@pytest.mark.parametrize("Bt,N,M,D", [(3, 40, 96, 32), (1, 5, 1, 3),
                                      (2, 33, 130, 129)])
def test_l1_plain_matches_pallas(Bt, N, M, D):
    """idx1 exact; d1/d2 to rtol 1e-5 (both add |a_k − b_k| in f32)."""
    rng = np.random.default_rng(13)
    a, b, vb = _l1_case(rng, Bt, N, M, D)
    got = [x.numpy() for x in ck.top2_l1_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(vb))]
    for lane in range(Bt):
        ref = _pallas_pair(a, b[lane], vb[lane], "l1")
        np.testing.assert_array_equal(got[1][lane], ref[1])
        np.testing.assert_allclose(got[0][lane], ref[0], rtol=1e-5)
        np.testing.assert_allclose(got[2][lane], ref[2], rtol=1e-5)


def test_l1_plain_all_masked_lane_and_ties():
    rng = np.random.default_rng(14)
    a, b, vb = _l1_case(rng, 3, 40, 96, 32)
    vb[1] = False
    b[0, 70] = b[0, 9]
    a[4] = b[0, 9]
    vb[0, [9, 70]] = True
    d1, i1, d2 = (x.numpy() for x in ck.top2_l1_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(vb)))
    ref = _pallas_pair(a, b[0], vb[0], "l1")
    np.testing.assert_array_equal(i1[0], ref[1])
    assert np.all(d1[1] == BIG) and np.all(d2[1] == BIG)
    assert np.all(i1[1] == 0)
    assert i1[0, 4] == 9 and d1[0, 4] == 0.0 and d2[0, 4] == 0.0


@pytest.mark.parametrize("lpb", [2, 4])
def test_batch_plain_multi_lane_matches_pallas(lpb):
    """top2_batch_plain with lanes_per_block against top2_pallas_batch with
    the same knob (B = 6 is not a multiple of 4: the lane padding path).
    idx1 exact; d1/d2 to rtol 1e-5 plus 4e-7·(|a|²+|b|²) for the float32
    cancellation, as tests/test_torch_kernels.py."""
    rng = np.random.default_rng(15)
    a = rng.normal(size=(200, 128)).astype(np.float32)
    b = rng.normal(size=(6, 300, 128)).astype(np.float32)
    vb = rng.random((6, 300)) >= 0.1
    ref = [np.asarray(x) for x in top2_pallas_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb), metric="l2",
        interpret=True, lanes_per_block=lpb)]
    got = [x.numpy() for x in ck.top2_batch_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(vb),
        lanes_per_block=lpb)]
    np.testing.assert_array_equal(got[1], ref[1])
    atol = 4e-7 * float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max())
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=atol)


def test_lanes_per_block_must_be_positive():
    a, b, vb = torch.zeros(2, 4), torch.zeros(1, 3, 4), torch.ones(1, 3,
                                                                  dtype=bool)
    with pytest.raises(ValueError, match="lanes_per_block"):
        ck.top2_batch(a, b, vb, lanes_per_block=0)


def _match_inputs(rng, metric, N=120, M=150, B=3):
    """Candidate sets with a perturbed copy of most query rows, so that
    the ratio test has clear winners and clear rejects."""
    if metric == "hamming":
        b = _bits(rng, B, M, 8)
        a = b[0, :N].copy()
        flip = _bits(rng, N, 8) & _bits(rng, N, 8) & _bits(rng, N, 8)
        a ^= flip & _bits(rng, N, 8)
        return a, b
    b = rng.random((B, M, 128)).astype(np.float32) * 40.0
    a = b[0, :N] + rng.normal(size=(N, 128)).astype(np.float32)
    a[N // 2:] = rng.random((N - N // 2, 128)).astype(np.float32) * 40.0
    return a, b


def _torch_desc(x):
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


@pytest.mark.parametrize("metric", ["l2", "l1", "hamming"])
def test_match_pair_matches_jax(metric):
    rng = np.random.default_rng(16)
    a, b = _match_inputs(rng, metric)
    va = rng.random(a.shape[0]) >= 0.05
    vb = rng.random(b.shape[1]) >= 0.05
    ref = jknn.match_pair(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b[0]),
                          jnp.asarray(vb), 0.8, metric)
    got = tknn.match_pair(_torch_desc(a), torch.from_numpy(va),
                          _torch_desc(b[0]), torch.from_numpy(vb), 0.8,
                          metric)
    want_match = np.asarray(ref["is_match"])
    np.testing.assert_array_equal(got["is_match"].numpy(), want_match)
    assert int(got["num_matches"]) == int(ref["num_matches"]) > 10
    np.testing.assert_array_equal(got["train_idx"].numpy()[want_match],
                                  np.asarray(ref["train_idx"])[want_match])
    # L2: |a|²+|b|²−2a·b cancels; 1e-6·(|a|²+|b|²) is ~8 float32 ulps of it
    atol = 1e-6 * float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max()) \
        if metric == "l2" else 0.0
    np.testing.assert_allclose(got["distance"].numpy()[want_match],
                               np.asarray(ref["distance"])[want_match],
                               rtol=1e-4, atol=atol)


def test_match_batch_l1_matches_jax():
    rng = np.random.default_rng(17)
    a, b = _match_inputs(rng, "l1")
    va = rng.random(a.shape[0]) >= 0.05
    vb = rng.random(b.shape[:2]) >= 0.05
    fm = np.array([True, True, False])
    ref = jknn.match_batch(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                           jnp.asarray(vb), jnp.asarray(fm), 0.8, "l1")
    got = tknn.match_batch(torch.from_numpy(a), torch.from_numpy(va),
                           torch.from_numpy(b), torch.from_numpy(vb),
                           torch.from_numpy(fm), 0.8, "l1")
    want_match = np.asarray(ref["is_match"])
    np.testing.assert_array_equal(got["is_match"].numpy(), want_match)
    np.testing.assert_array_equal(got["num_matches"].numpy(),
                                  np.asarray(ref["num_matches"]))
    assert int(got["num_matches"][0]) > 10
    np.testing.assert_array_equal(got["train_idx"].numpy()[want_match],
                                  np.asarray(ref["train_idx"])[want_match])


def test_cpu_wrappers_use_plain_versions_and_count_nothing():
    rng = np.random.default_rng(18)
    a, b, vb = _l1_case(rng, 2, 16, 24, 32)
    ta, tb, tv = (torch.from_numpy(x) for x in (a, b, vb))
    before = (ck.top2_l1.launches, ck.top2_pair.launches,
              ck.top2_batch.launches, ck.top2_batch.multi_lane_launches)
    for g, w in zip(ck.top2_l1(ta, tb, tv), ck.top2_l1_plain(ta, tb, tv)):
        assert torch.equal(g, w)
    for g, w in zip(ck.top2_pair(ta, tb[0], tv[0]),
                    ck.top2_pair_plain(ta, tb[0], tv[0])):
        assert torch.equal(g, w)
    for g, w in zip(ck.top2_batch(ta, tb, tv, lanes_per_block=2),
                    ck.top2_batch_plain(ta, tb, tv)):
        assert torch.equal(g, w)
    assert (ck.top2_l1.launches, ck.top2_pair.launches,
            ck.top2_batch.launches,
            ck.top2_batch.multi_lane_launches) == before


@pytest.mark.parametrize("N,M", [(2048, 2048), (1999, 1500), (300, 257),
                                 (5, 1), (4096, 33)])
def test_pair_splits_cover_every_column(N, M):
    S, per = ck.pair_splits(N, M, sms=132)
    assert per % ck.PAIR_COLS == 0 and per > 0
    assert (S - 1) * per < M <= S * per       # no empty range, all covered
    assert S <= max(1, -(-4 * 132 // -(-N // ck.PAIR_ROWS)))  # ~4 blocks/SM
