"""The port's windowed bundle adjustment against the JAX package's on the
same window (same numpy inputs), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.geometry import matrix_to_rodrigues as jm2r
from slam_indoor_code_tpu.solver import ba as jba
from slam_indoor_code_tpu_torch.solver import ba as tba

torch.set_num_threads(1)


def _window(scene, F=5, Kslots=160, P=220, seed=0):
    """An [F,K] observation grid over ``scene`` with noisy pixels, perturbed
    cameras and points, padding slots and padded point rows."""
    rng = np.random.default_rng(seed)
    n_pts = P - 20
    uv = np.zeros((F, Kslots, 2), np.float32)
    pidx = np.zeros((F, Kslots), np.int32)
    mask = np.zeros((F, Kslots), bool)
    for f in range(F):
        proj, vis = scene.project(f, noise=0.5, rng=rng)
        ids = np.flatnonzero(vis[:n_pts])[:Kslots - 10]
        uv[f, :len(ids)] = proj[ids]
        pidx[f, :len(ids)] = ids
        mask[f, :len(ids)] = True
    cams = np.zeros((F, 6), np.float32)
    for f in range(F):
        cams[f, :3] = np.asarray(jm2r(jnp.asarray(scene.rotations[f],
                                                   jnp.float32)))
        cams[f, 3:] = scene.translations[f]
    cams[1:] += rng.normal(0, 0.01, cams[1:].shape).astype(np.float32)
    pts = np.zeros((P, 3), np.float32)
    pts[:n_pts] = scene.points[:n_pts] + rng.normal(0, 0.05, (n_pts, 3))
    pmask = np.zeros(P, bool)
    pmask[:n_pts] = True
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2],
                   scene.K[1, 2]], np.float32)
    return K4, cams, pts, uv, pidx, mask, pmask


@pytest.mark.parametrize("loss,param,obs_cap,free_frac", [
    ("huber", 2.0, 0, None),
    ("cauchy", 1.0, 512, None),
    ("trivial", 1.0, 0, 0.5),
])
@pytest.mark.parametrize("max_iters", [3, 12])
def test_bundle_adjust_window_matches(scene, loss, param, obs_cap, free_frac,
                                      max_iters):
    """Final cost within 1e-4 relative (float32 LM on the same problem).
    With 3 iterations every step improves the cost by far more than the
    stop rule's 1e-6 relative, so both loops run the same count and the
    adjusted cameras agree to 1e-4.  Run to convergence, that rule fires on a step whose
    gain is below float32 summation noise (measured: the two packages' cost
    sequences agree to 2e-6 relative but cross 1e-6·cost at different
    iterations, or one never does, and the cameras then drift apart along
    the flat valley), so there only the cost is compared."""
    K4, cams, pts, uv, pidx, mask, pmask = _window(scene)
    free = None
    if free_frac is not None:
        free = np.arange(len(pmask)) >= int(free_frac * pmask.sum())
    kw = dict(loss=loss, loss_param=param, max_iters=max_iters,
              obs_cap=obs_cap,
              fix_intrinsics=True, gauge_frame0=free is None)
    jres = jba.bundle_adjust_window(
        jba.BAConfig(**kw), *map(jnp.asarray, (K4, cams, pts, uv, pidx, mask,
                                               pmask)),
        None if free is None else jnp.asarray(free))
    tres = tba.bundle_adjust_window(
        tba.BAConfig(**kw), *map(torch.from_numpy, (K4, cams, pts, uv, pidx,
                                                    mask, pmask)),
        None if free is None else torch.from_numpy(free))
    ji, ti = jres[3], tres[3]
    if max_iters == 3:
        assert int(ti["num_iters"]) == int(ji["num_iters"]) == 3
        np.testing.assert_allclose(tres[1].numpy(), np.asarray(jres[1]),
                                   atol=1e-4)
    assert int(ti["num_residuals"]) == int(ji["num_residuals"])
    np.testing.assert_allclose(float(ti["initial_cost"]),
                               float(ji["initial_cost"]), rtol=1e-5)
    np.testing.assert_allclose(float(ti["final_cost"]),
                               float(ji["final_cost"]), rtol=1e-4)
    assert float(ti["final_cost"]) < 0.5 * float(ti["initial_cost"])


def test_loss_rho_and_weight_matches():
    s = torch.linspace(0.0, 30.0, 301)
    for kind in ("trivial", "huber", "cauchy", "arctan", "tukey"):
        rho_t, w_t = tba.loss_rho_and_weight(s, kind, 2.0)
        rho_j, w_j = jba.loss_rho_and_weight(jnp.asarray(s.numpy()), kind, 2.0)
        np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6,
                                   atol=1e-6)


def test_inv3_matches(rng):
    M = rng.normal(size=(50, 3, 3)).astype(np.float32) + 3 * np.eye(3,
                                                                    dtype=np.float32)
    np.testing.assert_allclose(tba._inv3(torch.from_numpy(M)).numpy(),
                               np.asarray(jba._inv3(jnp.asarray(M))),
                               rtol=1e-5, atol=1e-6)
