"""Unrolled small-matrix kernels vs numpy oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.ops.linalg_small import (chol_unrolled, spd_inverse,
                                         tri_lower_inv_unrolled)


@pytest.mark.parametrize("n", [3, 24, 33])
def test_cholesky_matches_numpy(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(n, n))
    G = M @ M.T / n + 0.5 * np.eye(n)
    L = np.asarray(chol_unrolled(jnp.asarray(G)))
    np.testing.assert_allclose(L, np.linalg.cholesky(G), atol=1e-10)


def test_tri_inv():
    rng = np.random.default_rng(0)
    n = 24
    L = np.tril(rng.normal(size=(n, n))) + 2.0 * np.eye(n)
    Linv = np.asarray(tri_lower_inv_unrolled(jnp.asarray(L)))
    np.testing.assert_allclose(Linv @ L, np.eye(n), atol=1e-10)


@pytest.mark.parametrize("dtype,atol", [(jnp.float64, 1e-11),
                                        (jnp.float32, 2e-4)])
def test_spd_inverse(dtype, atol):
    rng = np.random.default_rng(1)
    n = 24
    M = rng.normal(size=(n, n))
    # Moderately ill-conditioned SPD (cond ~ 1e4).
    G = M @ M.T / n + 1e-3 * np.eye(n)
    X = np.asarray(spd_inverse(jnp.asarray(G, dtype)))
    np.testing.assert_allclose(X @ G, np.eye(n), atol=atol * 1e4)


def test_batched_vmap():
    rng = np.random.default_rng(2)
    n, B = 8, 16
    Ms = rng.normal(size=(B, n, n))
    Gs = np.einsum('bij,bkj->bik', Ms, Ms) / n + 0.5 * np.eye(n)
    Xs = np.asarray(jax.vmap(spd_inverse)(jnp.asarray(Gs)))
    for i in range(B):
        np.testing.assert_allclose(Xs[i] @ Gs[i], np.eye(n), atol=1e-9)
