"""The port's geometry against the JAX package's on the same numpy inputs:
rotations, projection and triangulation elementwise; essential and PnP
RANSAC with the same sampled index sets on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import geometry as jgeo
from slam_indoor_code_tpu.geometry import triangulate as jtri
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import geometry as tgeo
from slam_indoor_code_tpu_torch.geometry import ransac as transac
from slam_indoor_code_tpu_torch.geometry import triangulate as ttri

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x)


def test_rotations_roundtrip_and_parity(rng):
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[0] = 0.0                                   # θ = 0
    aa[1] = [np.pi - 1e-4, 0, 0]                  # near π
    aa[2] = [1e-5, -2e-5, 0]                      # small-angle branch
    R_j = _np(jgeo.rodrigues_to_matrix(jnp.asarray(aa)))
    R_t = tgeo.rodrigues_to_matrix(_t(aa)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=2e-6)
    np.testing.assert_allclose(
        tgeo.matrix_to_rodrigues(_t(R_j)).numpy(),
        _np(jgeo.matrix_to_rodrigues(jnp.asarray(R_j))), atol=2e-5)
    M = R_j + 0.01 * rng.normal(size=R_j.shape).astype(np.float32)
    np.testing.assert_allclose(tgeo.project_to_so3(_t(M)).numpy(),
                               _np(jgeo.project_to_so3(jnp.asarray(M))),
                               atol=2e-5)


def test_projection_and_undistort(scene):
    K, R, t = scene.K, scene.rotations[2], scene.translations[2]
    X = scene.points[:50]
    np.testing.assert_allclose(
        tgeo.project(_t(K), _t(R), _t(t), _t(X)).numpy(),
        _np(jgeo.project(jnp.asarray(K, jnp.float32), jnp.asarray(R, jnp.float32),
                         jnp.asarray(t, jnp.float32), jnp.asarray(X, jnp.float32))),
        rtol=1e-5, atol=1e-3)
    uv, _ = scene.project(2)
    dist = np.array([0.1, -0.05, 0.001, 0.002, 0.01], np.float32)
    np.testing.assert_allclose(
        tgeo.undistort_points(_t(K), _t(dist), _t(uv[:50])).numpy(),
        _np(jgeo.undistort_points(jnp.asarray(K, jnp.float32),
                                  jnp.asarray(dist), jnp.asarray(uv[:50], jnp.float32))),
        rtol=1e-5, atol=1e-3)


def _pair(scene, i=0, j=2, noise=0.3, n=200):
    rng = np.random.default_rng(7)
    uv1, v1 = scene.project(i, noise, rng)
    uv2, v2 = scene.project(j, noise, rng)
    vis = np.flatnonzero(v1 & v2)[:n]
    return uv1[vis].astype(np.float32), uv2[vis].astype(np.float32), vis


def test_triangulation_parity(scene):
    uv1, uv2, vis = _pair(scene)
    K = scene.K.astype(np.float32)
    R1, t1 = scene.rotations[0].astype(np.float32), scene.translations[0].astype(np.float32)
    R2, t2 = scene.rotations[2].astype(np.float32), scene.translations[2].astype(np.float32)
    mask = np.ones(len(vis), bool)
    mask[::7] = False
    args = (K, R1, t1, R2, t2, uv1, uv2)
    Xj = _np(jtri.triangulate_midpoint(*map(jnp.asarray, args), jnp.asarray(mask)))
    Xt = ttri.triangulate_midpoint(*map(_t, args), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)
    R1s = np.broadcast_to(R1, (len(vis), 3, 3)).copy()
    t1s = np.broadcast_to(t1, (len(vis), 3)).copy()
    aargs = (K, R1s, t1s, R2, t2, uv1, uv2)
    Xj, cj = jtri.triangulate_midpoint_anchored(*map(jnp.asarray, aargs))
    Xt, ct = ttri.triangulate_midpoint_anchored(*map(_t, aargs))
    np.testing.assert_allclose(Xt.numpy(), _np(Xj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ct.numpy(), _np(cj), atol=1e-6)
    # DLT (eigenvector signs differ between packages; the point does not)
    P1 = K @ np.concatenate([R1, t1[:, None]], 1)
    P2 = K @ np.concatenate([R2, t2[:, None]], 1)
    Xj = _np(jtri.triangulate_dlt(*map(jnp.asarray, (P1, P2, uv1, uv2))))
    Xt = ttri.triangulate_dlt(*map(_t, (P1, P2, uv1, uv2))).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-3, atol=1e-3)


def test_essential_ransac_same_samples_same_pose(scene):
    """Same sampled index sets → same pose.  Exact correspondences over a
    wide baseline: the 8-point nullspace is the smallest eigenvector of a
    float32 9×9 AᵀA, and on noisy or narrow-baseline pairs its eigen-gap is
    so small that two LAPACK builds (JAX's and torch's) disagree at ~1e-2
    while both sit equally far from a float64 solve (measured median 2e-2
    for each) — an f32 conditioning limit of the algorithm, not a port
    difference.  R to 1e-4; the unit translation to 5e-4 (measured 1.2e-4
    here: t is the worst-conditioned part of E)."""
    uv1, v1 = scene.project(0)
    uv2, v2 = scene.project(8)
    vis = np.flatnonzero(v1 & v2)[:300]
    uv1, uv2 = uv1[vis].astype(np.float32), uv2[vis].astype(np.float32)
    K = scene.K.astype(np.float32)
    mask = np.ones(len(vis), bool)
    mask[-20:] = False
    key = jax.random.PRNGKey(0)
    probs = jnp.asarray(mask, jnp.float32) / mask.sum()
    idx = np.array(jax.random.choice(key, len(vis), shape=(256, 8), p=probs))
    want = jgeo.estimate_transformation(
        key, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(mask), threshold_px=1.0, distance_threshold=500.0,
        num_hypotheses=256)
    got = tgeo.estimate_transformation(
        _t(K), _t(uv1), _t(uv2), torch.from_numpy(mask), threshold_px=1.0,
        distance_threshold=500.0, num_hypotheses=256,
        idx=torch.from_numpy(idx).long())
    np.testing.assert_allclose(got["R"].numpy(), _np(want["R"]), atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), _np(want["t"]), atol=5e-4)
    assert int(got["num_passed"]) == int(want["num_passed"])
    np.testing.assert_array_equal(got["chirality_mask"].numpy(),
                                  _np(want["chirality_mask"]))


def test_pnp_ransac_same_samples_same_pose(scene):
    rng = np.random.default_rng(11)
    uv, vis = scene.project(4, 0.5, rng)
    ids = np.flatnonzero(vis)[:256]
    X = scene.points[ids].astype(np.float32)
    X[::9] += rng.normal(0, 1.0, X[::9].shape).astype(np.float32)  # outliers
    uv = uv[ids].astype(np.float32)
    mask = np.ones(len(ids), bool)
    mask[-16:] = False
    K = scene.K.astype(np.float32)
    key = jax.random.PRNGKey(5)
    probs = jnp.asarray(mask, jnp.float32) / mask.sum()
    idx = np.array(jax.random.choice(key, len(ids), shape=(64, 6), p=probs))
    prior_R = scene.rotations[3].astype(np.float32)
    prior_t = scene.translations[3].astype(np.float32)
    want = jgeo.solve_pnp_ransac(
        key, jnp.asarray(K), jnp.asarray(X), jnp.asarray(uv),
        jnp.asarray(mask), num_hypotheses=64, prior_R=jnp.asarray(prior_R),
        prior_t=jnp.asarray(prior_t))
    got = tgeo.solve_pnp_ransac(
        _t(K), _t(X), _t(uv), torch.from_numpy(mask), num_hypotheses=64,
        prior_R=_t(prior_R), prior_t=_t(prior_t),
        idx=torch.from_numpy(idx).long())
    np.testing.assert_allclose(got["R"].numpy(), _np(want["R"]), atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), _np(want["t"]), atol=1e-4)
    assert int(got["num_inliers"]) == int(want["num_inliers"])


def test_sample_indices_stay_on_valid_slots():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 17, 40]] = True
    g = torch.Generator().manual_seed(0)
    idx = transac.sample_indices(mask, (200, 8), g)
    assert idx.shape == (200, 8)
    assert set(idx.unique().tolist()) == {3, 17, 40}
    none = transac.sample_indices(torch.zeros(5, dtype=torch.bool), (4, 2), g)
    assert int(none.max()) <= 4


@pytest.mark.parametrize("d", [4, 9, 12])
def test_smallest_eigenvector_on_the_cpu_is_lapack_float32(rng, d):
    """geometry/nullspace.py keeps the CPU on float32 LAPACK (the solver
    moves to float64 only on CUDA): bit for bit ``torch.linalg.eigh``'s
    smallest eigenvector at the DLT shapes (triangulation 4, the 8-point
    essential 9, PnP 12), float32 in, float32 out."""
    from slam_indoor_code_tpu_torch.geometry.nullspace import (
        smallest_eigenvector)

    A = torch.from_numpy(rng.normal(size=(64, d + 2, d)).astype(np.float32))
    AtA = A.transpose(1, 2) @ A
    got = smallest_eigenvector(AtA)
    assert got.dtype == torch.float32 and got.shape == (64, d)
    assert torch.equal(got, torch.linalg.eigh(AtA)[1][..., 0])
