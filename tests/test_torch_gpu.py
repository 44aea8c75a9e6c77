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
def test_kernel_at_the_hybrid_shape_on_card(cuda_device):
    """The hybrid descriptor's shape on the path (2048 keypoints, 16
    candidate frames, D = 384): 128 SIFT-like columns beside 256 columns of
    α·bits (α = 0.08) with duplicate rows, through ``knn.match_batch``: one
    launch, the L2 rule against the plain version."""
    from slam_indoor_code_tpu_torch.ops import knn

    rng = np.random.default_rng(11)

    def hybrid(*shape):
        sift = np.abs(rng.normal(size=shape + (128,))).astype(np.float32)
        sift /= np.linalg.norm(sift, axis=-1, keepdims=True)
        bits = rng.integers(0, 2, shape + (256,)).astype(np.float32)
        return np.concatenate([sift, np.float32(0.08) * bits], -1)

    a, b = hybrid(2048), hybrid(16, 2048)
    b[3, :100] = a[:100]                     # exact matches in one lane
    vb = rng.random((16, 2048)) >= 0.1
    vb[3, :100] = True
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, b, vb)]
    _hold_l2(ck.top2_batch(*args), ck.top2_batch_plain(*args), a, b)
    before = ck.top2_batch.launches
    res = knn.match_batch(args[0], torch.ones(2048, dtype=torch.bool,
                                              device=cuda_device),
                          args[1], args[2],
                          torch.ones(16, dtype=torch.bool,
                                     device=cuda_device), 0.8, "l2")
    torch.cuda.synchronize()
    assert ck.top2_batch.launches == before + 1
    assert int(res["num_matches"][3]) >= 95


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


@pytest.mark.gpu
def test_orb_describe_on_card_equals_cpu(cuda_device):
    """ORB on the card against the same function on the CPU, on a rendered
    frame's FAST keypoints: angles within 1e-4 rad, ≥ 99.5 % of the bits
    equal (the card's cos/sin/atan2 may differ in the last ulp and move a
    pattern point across a rounding tie), invalid rows all zero."""
    from slam_indoor_code_tpu_torch.ops import fast, image, orb
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=1500, n_frames=2, image_size=(1080, 1920),
                       seed=7, baseline=0.25, kind="hallway")
    gray = image.rgb_to_gray(torch.from_numpy(scene.render(0)))
    det = fast.detect(gray, 20.0, 2048)
    assert int(det["valid"].sum()) > 1000
    want = orb.describe(gray, det["xy"], det["valid"])
    got = orb.describe(*(t.to(cuda_device) for t in (gray, det["xy"],
                                                     det["valid"])))
    assert got["desc"].dtype == torch.int32
    assert got["desc"].device.type == cuda_device.type
    v = det["valid"].numpy()
    d_ang = np.abs(np.angle(np.exp(1j * (got["angle"].cpu().numpy()
                                         - want["angle"].numpy()))))
    assert d_ang[v].max() < 1e-4
    gb = np.unpackbits(got["desc"].cpu().numpy()[v].view(np.uint8))
    wb = np.unpackbits(want["desc"].numpy()[v].view(np.uint8))
    assert (gb == wb).mean() >= 0.995
    assert (got["desc"].cpu().numpy()[~v] == 0).all()


@pytest.mark.gpu
def test_match_batch_hamming_on_orb_words_launches_the_kernel(cuda_device):
    """knn.match_batch with metric "hamming" on ORB words of rendered frames
    launches the Hamming top2_batch once (never top2_l1 or top2_pair) and
    equals the CPU path exactly (0/1 sums are exact in f32, and both keep
    the lowest column of a tie)."""
    from slam_indoor_code_tpu_torch.ops import fast, image, knn, orb
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=700, n_frames=5, seed=5, baseline=0.3)
    descs, valids = [], []
    for i in range(5):
        g = image.rgb_to_gray(torch.from_numpy(scene.render(i)))
        det = fast.detect(g, 20.0, 512)
        d = orb.describe(g, det["xy"], det["valid"])
        descs.append(d["desc"])
        valids.append(d["valid"])
    a, va = descs[0], valids[0]
    b, vb = torch.stack(descs[1:]), torch.stack(valids[1:])
    fm = torch.tensor([True, True, True, False])
    before = (ck.top2_batch.launches, ck.top2_batch.hamming_launches,
              ck.top2_l1.launches, ck.top2_pair.launches)
    got = knn.match_batch(*(t.to(cuda_device) for t in (a, va, b, vb, fm)),
                          ratio=0.8, metric="hamming")
    assert (ck.top2_batch.launches, ck.top2_batch.hamming_launches,
            ck.top2_l1.launches, ck.top2_pair.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    want = knn.match_batch(a, va, b, vb, fm, ratio=0.8, metric="hamming")
    for k in ("train_idx", "is_match", "distance", "num_matches"):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert int(want["num_matches"][0]) > 50


@pytest.mark.gpu
def test_global_bundle_adjust_repeats_bitwise_on_card(cuda_device):
    """The final global BA on the card: two solves give the same bits (every
    segment sum is the fixed-order one), camera 0 stays fixed, and the
    cameras agree with the CPU solve within 1e-3."""
    from slam_indoor_code_tpu_torch.geometry.rotations import \
        matrix_to_rodrigues
    from slam_indoor_code_tpu_torch.solver.global_ba import (
        GlobalBAConfig, global_bundle_adjust)
    from slam_indoor_code_tpu_torch.testing import make_scene

    N, P = 24, 800
    sc = make_scene(n_points=P, n_frames=N, seed=3, baseline=0.3,
                    kind="hallway")
    rng = np.random.default_rng(0)
    uv, ci, pi = [], [], []
    for f in range(N):
        uvf, vis = sc.project(f, noise=0.4, rng=rng)
        ids = np.flatnonzero(vis)[:400]
        uv.append(uvf[ids])
        ci.append(np.full(len(ids), f))
        pi.append(ids)
    uv = torch.from_numpy(np.concatenate(uv).astype(np.float32))
    ci = torch.from_numpy(np.concatenate(ci))
    pi = torch.from_numpy(np.concatenate(pi))
    mask = torch.ones(len(uv), dtype=torch.bool)
    aa = matrix_to_rodrigues(torch.from_numpy(sc.rotations)).float()
    drift = torch.from_numpy(rng.normal(0, 0.01, (N, 6))).float()
    cams = torch.cat([aa, torch.from_numpy(sc.translations).float()], 1)
    cams = cams + drift * (torch.arange(N)[:, None] > 0)
    pts = torch.from_numpy(sc.points.astype(np.float32)
                           + rng.normal(0, 0.05, (P, 3)).astype(np.float32))
    K4 = torch.tensor([sc.K[0, 0], sc.K[1, 1], sc.K[0, 2], sc.K[1, 2]],
                      dtype=torch.float32)
    cfg = GlobalBAConfig(max_iters=10, cg_iters=16)
    args = [t.to(cuda_device) for t in (K4, cams, pts, uv, ci, pi, mask)]
    c1, p1, i1 = global_bundle_adjust(cfg, *args)
    c2, p2, _ = global_bundle_adjust(cfg, *args)
    assert torch.equal(c1, c2) and torch.equal(p1, p2)
    assert torch.equal(c1[0].cpu(), cams[0])
    cc, _, ic = global_bundle_adjust(cfg, K4, cams, pts, uv, ci, pi, mask)
    np.testing.assert_allclose(c1.cpu().numpy(), cc.numpy(), atol=1e-3)
    assert float(i1["final_rmse"]) < float(i1["initial_rmse"])


@pytest.mark.gpu
def test_streaming_path_repeats_bitwise_on_card(cuda_device, tmp_path):
    """Host ingest and the streaming loop on the card at rt_scene's size
    (480x640, 14 frames; tests/test_torch_streaming.py's configuration): two
    runs give the same cameras, poses and map bit for bit, every scan step
    and the bootstrap match through top2_batch, and no other kernel runs."""
    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.config import Config, TpuConfig
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine
    from slam_indoor_code_tpu_torch.testing import make_scene

    sc = make_scene(n_points=700, n_frames=14, seed=5, baseline=0.3)
    frames = [sc.render(i) for i in range(14)]
    engines = []
    orig = DeviceEngine.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        engines.append(self)

    runs = []
    DeviceEngine.__init__ = spy
    try:
        for i in range(2):
            cfg = Config(
                usePhotosCycle=True, outputDataDir=str(tmp_path / str(i)),
                requiredExtractedPointsCount=80,
                featureExtractingThreshold=20, framesBatchSize=6,
                requiredMatchedPointsCount=30, knnMatcherDistance=0.8,
                RPDistanceThreshold=500.0, useBundleAdjustment=True,
                BAMaxFramesCnt=4, BAUseHuberLossFunction=True,
                BAHuberLossFunctionParameter=2.0,
                tpu=TpuConfig(max_keypoints=512, ransac_iters=256,
                              pnp_ransac_iters=128, window_points=4096,
                              ba_max_iters=12, ingest="host",
                              host_descriptor="same", streaming=True))
            before = (ck.top2_batch.launches, ck.top2_l1.launches,
                      ck.top2_pair.launches)
            gd = slam_main(cfg, sc.K, frames=frames, seed=0)
            torch.cuda.synchronize()
            eng = engines[-1]
            n = ck.top2_batch.launches - before[0]
            assert eng._will_stream and eng.stream_calls > 0
            assert n == eng.stream_steps + eng.match_select_calls
            assert (ck.top2_l1.launches, ck.top2_pair.launches) == before[1:]
            runs.append(gd)
    finally:
        DeviceEngine.__init__ = orig
    a, b = runs
    assert len(a.rotations) >= 10
    np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
    for x, y in ((a.rotations, b.rotations), (a.positions, b.positions),
                 (a.points, b.points)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert all(t.device.type == "cuda"
               for t in engines[-1].state.tensors().values())


@pytest.mark.gpu
def test_auto_ingest_resolves_to_device_on_card(cuda_device):
    """On a PCIe-attached card the probe reads well above 400 MB/s, so
    ingest="auto" keeps the all-device frontend, as the JAX package's rule
    concludes there."""
    from slam_indoor_code_tpu_torch.runtime.engine import (
        measured_link_bandwidth_mbps, resolve_ingest)

    assert measured_link_bandwidth_mbps(cuda_device) > 400.0
    assert resolve_ingest("auto", cuda_device) == "device"


def _small_config(out, **over):
    """tests/test_pipeline.py's configuration (rt_scene's 480x640)."""
    from slam_indoor_code_tpu_torch.config import Config, TpuConfig

    base = dict(usePhotosCycle=True, outputDataDir=str(out),
                requiredExtractedPointsCount=80,
                featureExtractingThreshold=20, framesBatchSize=6,
                requiredMatchedPointsCount=30, knnMatcherDistance=0.8,
                RPDistanceThreshold=500.0, useBundleAdjustment=True,
                BAMaxFramesCnt=6, BAUseHuberLossFunction=True,
                BAHuberLossFunctionParameter=2.0,
                tpu=TpuConfig(max_keypoints=512, ransac_iters=256,
                              pnp_ransac_iters=128, window_points=4096,
                              ba_max_iters=12))
    base.update(over)
    return Config(**base)


def _write_png(path, rgb):
    """An 8-bit RGB PNG, rows filtered Sub and Up in turn (numpy + zlib)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3)
    filt = rows.copy()
    filt[1::2, 3:] -= rows[1::2, :-3]          # Sub on odd rows
    filt[2::2] -= rows[1:-1:2]                 # Up on even rows after 0
    kinds = np.where(np.arange(h) % 2 == 1, 1, 2).astype(np.uint8)
    kinds[0] = 0
    raw = np.concatenate([kinds[:, None], filt], 1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.gpu
def test_classic_conductor_launches_top2_batch_per_scan_on_card(
        cuda_device, tmp_path):
    """``tpu.device_runtime=false`` on the card: one top2_batch launch per
    find_good_frame scan that matched, the descriptors on the card, no
    other kernel; the cameras carry their source frame ids."""
    import dataclasses

    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.pipeline import MainCycle
    from slam_indoor_code_tpu_torch.testing import make_scene

    sc = make_scene(n_points=700, n_frames=12, seed=5, baseline=0.3)
    frames = [sc.render(i) for i in range(12)]
    cfg = _small_config(tmp_path)
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, device_runtime=False))
    cycles = []
    orig = MainCycle.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        cycles.append(self)

    before = (ck.top2_batch.launches, ck.top2_l1.launches,
              ck.top2_pair.launches)
    MainCycle.__init__ = spy
    try:
        gd = slam_main(cfg, sc.K, frames=frames, seed=0)
    finally:
        MainCycle.__init__ = orig
    torch.cuda.synchronize()
    sched = cycles[0].scheduler
    assert sched.scans > 0
    assert ck.top2_batch.launches - before[0] == sched.scans
    assert (ck.top2_l1.launches, ck.top2_pair.launches) == before[1:]
    assert cycles[0].K.device.type == "cuda"
    assert len(gd.rotations) >= 10
    assert list(gd.frame_ids) == sorted(set(int(f) for f in gd.frame_ids))


@pytest.mark.gpu
def test_media_source_decodes_on_card_machine(cuda_device, tmp_path):
    """Photo media decodes on the card's machine (natively where libpng
    builds, else with the port's PNG reader) to the frames written; JPEG
    (io/jpeg.py where libjpeg does not build) gives cv2's decode of the
    committed fixtures (their sha256), skips a corrupt file, and an MJPEG
    AVI of the fixture frames reads back frame for frame."""
    import hashlib
    import json
    import pathlib

    from slam_indoor_code_tpu_torch.io import jpeg
    from slam_indoor_code_tpu_torch.io.media import MediaSource, _imread_rgb
    from slam_indoor_code_tpu_torch.testing import mjpeg

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
              for _ in range(11)]
    for i, f in enumerate(frames):
        _write_png(str(tmp_path / f"img{i}.png"), f)
    src = MediaSource(photos_pattern=str(tmp_path / "*.png"), threads=3)
    got = list(src)
    assert len(got) == len(frames)
    for a, b in zip(got, frames):        # img2 before img10: natural order
        np.testing.assert_array_equal(a, b)
    fixtures = (pathlib.Path(__file__).resolve().parent.parent
                / "slam_indoor_code_tpu_torch" / "testing" / "jpeg_fixtures")
    table = json.loads((fixtures / "cv2_sha256.json").read_text())
    for name, want in table.items():
        img = _imread_rgb(str(fixtures / name))
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    assert _imread_rgb(str(tmp_path / "x.jpg")) is None
    jpegs = [mjpeg.encode_jpeg(f) for f in frames[:4]]
    mjpeg.write_avi(str(tmp_path / "v.avi"), jpegs, 80, 60)
    video = list(MediaSource(video_path=str(tmp_path / "v.avi"),
                             use_photos=False, threads=3))
    assert len(video) == 4
    for a, j in zip(video, jpegs):
        np.testing.assert_array_equal(a, jpeg.decode(j))


@pytest.mark.gpu
def test_cli_defaults_to_cuda_on_card(cuda_device, tmp_path):
    """``python -m slam_indoor_code_tpu_torch cfg.json`` (no --device) runs
    the device runtime on the card and prints the map points line."""
    import contextlib
    import dataclasses
    import io

    from slam_indoor_code_tpu_torch import cli
    from slam_indoor_code_tpu_torch.config import dump_config
    from slam_indoor_code_tpu_torch.io.xmlio import save_matrix_to_xml
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine
    from slam_indoor_code_tpu_torch.testing import make_scene

    sc = make_scene(n_points=700, n_frames=10, seed=5, baseline=0.3)
    (tmp_path / "photos").mkdir()
    for i in range(10):
        _write_png(str(tmp_path / "photos" / f"frame_{i:03d}.png"),
                   sc.render(i))
    save_matrix_to_xml(str(tmp_path / "cam.xml"), sc.K, "K")
    cfg = dataclasses.replace(
        _small_config(tmp_path / "out", BAMaxFramesCnt=8),
        photosPathPattern=str(tmp_path / "photos" / "*.png"),
        calibrationPath=str(tmp_path / "cam.xml"))
    (tmp_path / "out").mkdir()
    (tmp_path / "cfg.json").write_text(dump_config(cfg))
    devices = []
    orig = DeviceEngine.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        devices.append(self.device)

    DeviceEngine.__init__ = spy
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(tmp_path / "cfg.json")])
    finally:
        DeviceEngine.__init__ = orig
    assert rc == 0 and "map points:" in buf.getvalue()
    assert [d.type for d in devices] == ["cuda"]


@pytest.mark.gpu
@pytest.mark.parametrize("descriptor,metric", [("sift", "l2"),
                                               ("orb", "hamming")])
def test_sharded_frontend_counts_on_card(cuda_device, descriptor, metric):
    """ShardedFrontend on 8 shards of one card (B = 16, two frames a
    shard): the unsplit call's match counts exactly, one top2_batch launch
    per shard."""
    from slam_indoor_code_tpu_torch.models import frontend as fe
    from slam_indoor_code_tpu_torch.parallel import ShardedFrontend, make_mesh
    from slam_indoor_code_tpu_torch.testing import make_scene

    sc = make_scene(n_points=500, n_frames=16, seed=3)
    fcfg = fe.FrontendConfig(max_keypoints=512, threshold=20.0,
                             descriptor=descriptor, ratio=0.8, metric=metric)
    rgb = torch.from_numpy(np.stack([sc.render(i) for i in range(16)])).cuda()
    mesh = make_mesh((8,), ("batch",), devices=[torch.device("cuda", 0)] * 8)
    sf = ShardedFrontend(mesh, fcfg)
    res = sf.extract_and_describe_batch(rgb)
    ref = fe.extract_and_describe_batch(fcfg, rgb)
    assert torch.equal(res["valid"], ref["valid"])
    prev = fe.extract_and_describe(fcfg, rgb[0])
    mask = torch.ones(16, dtype=torch.bool, device="cuda")
    before = ck.top2_batch.launches
    m_sh = sf.match_against_batch(prev["desc"], prev["valid"], res["desc"],
                                  res["valid"], mask)
    assert ck.top2_batch.launches - before == 8
    m_ref = fe.match_against_batch(fcfg, prev["desc"], prev["valid"],
                                   res["desc"], res["valid"], mask)
    assert torch.equal(m_sh["num_matches"], m_ref["num_matches"])
    assert int(m_sh["num_matches"][1]) > 50


@pytest.mark.gpu
def test_sharded_ba_on_card_equals_one_shard(cuda_device):
    """ShardedBA over 8 shards of one card against the one-shard solve:
    final cost within 1e-3 relative, cameras within 5e-4."""
    from slam_indoor_code_tpu_torch.parallel import ShardedBA, make_mesh
    from slam_indoor_code_tpu_torch.parallel.worker import build_ba_problem
    from slam_indoor_code_tpu_torch.solver.ba import BAConfig

    prob = build_ba_problem(F=8, Kslots=512, Pn=1024)
    cfg = BAConfig(loss="huber", loss_param=2.0, max_iters=8,
                   fix_intrinsics=True)
    dev = torch.device("cuda", 0)
    eight = ShardedBA(make_mesh((8,), devices=[dev] * 8), cfg,
                      window=8).solve(*prob)
    one = ShardedBA(make_mesh((1,), devices=[dev]), cfg, window=8).solve(*prob)
    assert eight.final_cost < eight.initial_cost
    assert abs(eight.final_cost - one.final_cost) / one.final_cost < 1e-3
    np.testing.assert_allclose(eight.cams, one.cams, atol=5e-4)


@pytest.mark.gpu
def test_calibrate_on_card_matches_cpu(cuda_device):
    """calibrate_camera on the card against the CPU on the same views: K
    within 2e-3 relative, rms within 0.01 px."""
    from slam_indoor_code_tpu_torch.calibration import (calibrate_camera,
                                                        make_object_points)

    rng = np.random.default_rng(9)
    K_gt = np.array([[900.0, 0, 330.0], [0, 910.0, 250.0], [0, 0, 1.0]])
    obj = make_object_points()
    views = []
    for _ in range(8):
        aa = rng.normal(0, 0.3, 3)
        R = torch.linalg.matrix_exp(torch.tensor(
            [[0, -aa[2], aa[1]], [aa[2], 0, -aa[0]], [-aa[1], aa[0], 0]],
            dtype=torch.float64)).numpy()
        t = np.array([rng.uniform(-40, 40), rng.uniform(-40, 40),
                      rng.uniform(320, 520)])
        Xc = obj @ R.T + t
        uv = (Xc @ K_gt.T)[:, :2] / Xc[:, 2:]
        views.append(uv + rng.normal(0, 0.1, uv.shape))
    Kc, _, _, _, rms_c = calibrate_camera(obj, views, device="cuda")
    Kp, _, _, _, rms_p = calibrate_camera(obj, views, device="cpu")
    np.testing.assert_allclose(Kc, Kp, rtol=2e-3, atol=0)
    assert abs(rms_c - rms_p) < 0.01
    assert abs(Kc[0, 0] - 900.0) / 900.0 < 0.01


@pytest.mark.gpu
def test_board_render_on_card_equals_cpu(cuda_device):
    """testing/board.py on the card: the undistorted render (the warp)
    equals the CPU's bit for bit; the distorted one differs in at most one
    4x4 sub-sample on a few edge pixels, and detection on it lands within
    0.01 px of detection on the CPU's."""
    from slam_indoor_code_tpu_torch.calibration import chessboard as cb
    from slam_indoor_code_tpu_torch.testing import board

    K = np.array([[1728.0, 0, 960.0], [0, 1728.0, 540.0], [0, 0, 1.0]])
    R = torch.linalg.matrix_exp(torch.tensor(
        [[0, -0.5, 0.2], [0.5, 0, -0.3], [-0.2, 0.3, 0]],
        dtype=torch.float64)).numpy()
    t = np.array([-20.0, 10.0, 560.0]) - R @ np.array([60.0, 60.0, 0.0])
    size = (1080, 1920)
    for dist in (np.zeros(5), np.array([0.08, -0.15, 1e-3, -5e-4, 0.0])):
        cpu = board.render_view(K, dist, R, t, size, noise=2, seed=1)
        card = board.render_view(K, dist, R, t, size, noise=2, seed=1,
                                 device="cuda")
        diff = np.abs(cpu.astype(int) - card)
        if not dist.any():
            np.testing.assert_array_equal(card, cpu)
        assert diff.max() <= 16 and (diff > 0).mean() < 1e-3
        got = cb.find_chessboard_corners(card.astype(np.float64))
        want = cb.find_chessboard_corners(cpu.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=0, atol=0.01)


@pytest.mark.gpu
def test_engine_mesh_needs_distinct_cards(cuda_device):
    from slam_indoor_code_tpu_torch.io.media import ArraySource
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig

    n = torch.cuda.device_count() + 1
    cfg = EngineConfig(max_keypoints=128, window_points=256, mesh_shape=(n,))
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    with pytest.raises(ValueError, match=f"needs {n} devices, have {n - 1}"):
        DeviceEngine(ArraySource([np.zeros((480, 640, 3), np.uint8)]), K,
                     cfg, batch_size=4, required_extracted=10)


@pytest.mark.gpu
def test_sequences_on_card_equal_solo_runs(cuda_device, tmp_path):
    """Two small sequences at once on the card(s), each on a stream of its
    own: each equals its solo run bit for bit."""
    from slam_indoor_code_tpu_torch.app import (run_sequences_parallel,
                                                slam_main)
    from slam_indoor_code_tpu_torch.config import Config, TpuConfig
    from slam_indoor_code_tpu_torch.testing import make_scene

    def cfg(sub):
        return Config(
            usePhotosCycle=True, outputDataDir=str(tmp_path / sub),
            requiredExtractedPointsCount=40, featureExtractingThreshold=15,
            framesBatchSize=5, requiredMatchedPointsCount=20,
            knnMatcherDistance=0.85, RPDistanceThreshold=500.0,
            tpu=TpuConfig(max_keypoints=256, ransac_iters=128,
                          pnp_ransac_iters=64, window_points=1024))

    scenes = [make_scene(500, 10, seed=s, baseline=0.3, kind="hallway",
                         image_size=(240, 320)) for s in (1, 2)]
    frames = [[sc.render(j) for j in range(10)] for sc in scenes]
    out = run_sequences_parallel([cfg("a"), cfg("b")],
                                 [sc.K for sc in scenes], frames)
    for i, (sc, gd) in enumerate(zip(scenes, out)):
        solo = slam_main(cfg(f"solo{i}"), sc.K, frames=frames[i], seed=i)
        assert len(gd.rotations) >= 6
        np.testing.assert_array_equal(gd.frame_ids, solo.frame_ids)
        np.testing.assert_array_equal(np.asarray(gd.rotations),
                                      np.asarray(solo.rotations))
        np.testing.assert_array_equal(gd.points, solo.points)


@pytest.mark.gpu
def test_smallest_eigenvector_on_card_equals_lapack(cuda_device):
    """geometry/nullspace.py on CUDA gives LAPACK's smallest eigenvector
    (float64 on the CPU) on near-singular PnP-shaped 12x12 AᵀA: a near-flat
    6-point cloud, as minimal samples on a wall give; cuSOLVER's float32
    batched solver does not."""
    from slam_indoor_code_tpu_torch.geometry.nullspace import (
        smallest_eigenvector)

    g = torch.Generator().manual_seed(0)
    X = (torch.randn(4096, 6, 3, generator=g)
         * torch.tensor([2.0, 1.0, 0.05]) + torch.tensor([0.0, 0.0, 5.0]))
    x = torch.randn(4096, 6, 2, generator=g) * 0.3
    Xh = torch.cat([X, torch.ones(4096, 6, 1)], -1)
    zeros = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, zeros, -x[..., :1] * Xh], -1),
                   torch.cat([zeros, Xh, -x[..., 1:] * Xh], -1)], 1)
    AtA = torch.einsum("sij,sik->sjk", A, A)
    want = torch.linalg.eigh(AtA.double())[1][..., 0]
    got = smallest_eigenvector(AtA.to(cuda_device)).cpu().double()
    cos = (got * want).sum(-1).abs()
    assert float(cos.min()) > 0.9999, float(cos.min())
