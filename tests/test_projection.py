"""Projection algebra oracles (reference testProjection.cpp:36-64 analogue):
null-space and particular-solution identities on random systems."""

import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.ops.projection import (lu_projection, qr_projection)

NC, NU, NX = 10, 20, 30


@pytest.mark.parametrize("proj_fn", [qr_projection, lu_projection])
def test_projection_identities(proj_fn):
    rng = np.random.default_rng(0)
    C = jnp.asarray(rng.normal(size=(NC, NX)))
    D = jnp.asarray(rng.normal(size=(NC, NU)))
    e = jnp.asarray(rng.normal(size=NC))
    P = proj_fn(C, D, e)
    # Null space: D Pu = 0
    np.testing.assert_allclose(np.asarray(D @ P.Pu), 0.0, atol=1e-10)
    # Particular solution: C dx + D (Pu w + Px dx + Pe) + e == 0 for any dx, w
    for _ in range(3):
        dx = rng.normal(size=NX)
        w = rng.normal(size=NU - NC)
        du = np.asarray(P.Pu) @ w + np.asarray(P.Px) @ dx + np.asarray(P.Pe)
        res = np.asarray(C) @ dx + np.asarray(D) @ du + np.asarray(e)
        np.testing.assert_allclose(res, 0.0, atol=1e-9)
    # Pu has orthonormal columns (full column rank nu - nc)
    np.testing.assert_allclose(np.asarray(P.Pu.T @ P.Pu), np.eye(NU - NC),
                               atol=1e-10)
