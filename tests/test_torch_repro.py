"""The two ops that made the port's card runs differ from run to run, held
against the JAX package's rule on the CPU: ``steps._scatter_drop`` (a
scatter whose indices repeat: the last write wins, out-of-range rows drop)
and ``ba._segment_sum`` (a fixed-order segment sum)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.runtime.steps import _scatter_drop
from slam_indoor_code_tpu_torch.solver.ba import _segment_sum

torch.set_num_threads(1)


def _jax_set_drop(base, idx, val):
    return np.asarray(jnp.asarray(base).at[jnp.asarray(idx)].set(
        jnp.asarray(val), mode="drop"))


def test_scatter_drop_last_write_wins():
    """The case worked by hand: idx [1,1,2,4,1,0,0] into 4 rows."""
    idx = np.array([1, 1, 2, 4, 1, 0, 0])
    val = np.arange(10.0, 17.0, dtype=np.float32)
    got = _scatter_drop(torch.zeros(4), torch.from_numpy(idx),
                        torch.from_numpy(val)).numpy()
    np.testing.assert_array_equal(got, [16.0, 14.0, 12.0, 0.0])
    np.testing.assert_array_equal(got, _jax_set_drop(np.zeros(4, np.float32),
                                                     idx, val))


@pytest.mark.parametrize("seed,n,k,width,dtype", [
    (0, 64, 200, None, np.int64),     # prev_corr-like ids, many repeats
    (1, 64, 200, 6, np.float32),      # anchor cameras
    (2, 300, 300, 2, np.float32),     # anchor pixels
    (3, 5, 40, 3, np.float32),        # nearly every row repeated
    (4, 128, 16, None, np.int64),     # few writes, most rows untouched
])
def test_scatter_drop_matches_jax(seed, n, k, width, dtype):
    """Repeated and dropped (idx == n) indices give exactly JAX's result."""
    rng = np.random.default_rng(seed)
    shape = (n,) if width is None else (n, width)
    vshape = (k,) if width is None else (k, width)
    if dtype == np.int64:
        base = rng.integers(-1, 1000, shape).astype(dtype)
        val = rng.integers(-1, 1000, vshape).astype(dtype)
    else:
        base = rng.normal(size=shape).astype(dtype)
        val = rng.normal(size=vshape).astype(dtype)
    idx = rng.integers(0, n + 1, k)             # n = dropped
    idx[: k // 4] = rng.integers(0, 3, k // 4)  # force repeats
    got = _scatter_drop(torch.from_numpy(base), torch.from_numpy(idx),
                        torch.from_numpy(val)).numpy()
    want = _jax_set_drop(base, idx, val)
    assert got.dtype == base.dtype
    np.testing.assert_array_equal(got, want.astype(base.dtype))


@pytest.mark.parametrize("seed,rows,width,n", [
    (0, 4096, 9, 300),      # V blocks, [O, 9]
    (1, 2048, 3, 50),       # b_p, [O, 3]
    (2, 1024, 120, 37),     # GP rows, [O, D*3]
])
def test_segment_sum_matches_jax(seed, rows, width, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, width)).astype(np.float32)
    ids = rng.integers(0, n, rows)
    got = _segment_sum(torch.from_numpy(x), torch.from_numpy(ids), n).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                          num_segments=n))
    scale = np.abs(x).sum() / n
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def test_segment_sum_masked_rows_add_exact_zeros():
    """Masked observations land on point 0 with weight 0 (ba.py's
    pid_safe): they leave every sum bit for bit as it was."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(500, 9)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, 500))
    masked = torch.zeros((300, 9))
    both = _segment_sum(torch.cat([x, masked]),
                        torch.cat([ids, torch.zeros(300, dtype=ids.dtype)]),
                        40)
    assert torch.equal(both, _segment_sum(x, ids, 40))
