"""Small-matrix linear algebra, unrolled at trace time.

XLA can lower ``jnp.linalg.cholesky`` / ``cho_solve`` on small matrices to
serial column loops with dynamic slicing, much slower than the surrounding
batched matmuls of the Riccati recursion. These replacements unroll the
factorizations at trace time into static elementwise/outer-product steps,
which XLA fuses into a handful of passes, and produce an *explicit inverse*
so every downstream solve is a plain matmul.

This is the role BLASFEO's hand-tuned small-matrix kernels play in the
reference stack (fetched by ``ocs2_sqp/blasfeo_catkin``); here the "hand
tuning" is trace-time unrolling + the batch axis supplied by ``vmap``.

Accuracy: explicit inversion loses ~cond(G)*eps (the optimum for an
explicit inverse); the IPM's barrier-weight clip and convergence freeze keep
cond within what f32 tolerates, and the f64 test oracles certify the
end-to-end behavior.
"""

from __future__ import annotations

import jax.numpy as jnp


def chol_unrolled(G: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky factor of an SPD matrix, statically unrolled.

    G: (..., n, n). Right-looking rank-1-update form: n outer products,
    all batched elementwise — no dynamic slicing.
    """
    n = G.shape[-1]
    idx = jnp.arange(n)
    M = G
    cols = []
    for j in range(n):
        d = jnp.sqrt(M[..., j, j])
        col = M[..., :, j] / d[..., None]
        col = jnp.where(idx >= j, col, 0.0)
        cols.append(col)
        M = M - col[..., :, None] * col[..., None, :]
    return jnp.stack(cols, axis=-1)


def tri_lower_inv_unrolled(L: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a lower-triangular matrix, statically unrolled.

    Row-by-row forward substitution: row_i = (e_i - L[i,:i] @ rows) / L[i,i].
    """
    n = L.shape[-1]
    eye = jnp.eye(n, dtype=L.dtype)
    rows = []
    for i in range(n):
        acc = eye[i]
        for j in range(i):
            acc = acc - L[..., i, j][..., None] * rows[j]
        rows.append(acc / L[..., i, i][..., None])
    return jnp.stack(rows, axis=-2)


def _inv3(G: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of (..., 3, 3) — fully parallel."""
    a, b, c = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    d, e, f = G[..., 1, 0], G[..., 1, 1], G[..., 1, 2]
    g, h, i = G[..., 2, 0], G[..., 2, 1], G[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    row0 = jnp.stack([A, -(b * i - c * h), (b * f - c * e)], axis=-1)
    row1 = jnp.stack([B, (a * i - c * g), -(a * f - c * d)], axis=-1)
    row2 = jnp.stack([C, -(a * h - b * g), (a * e - b * d)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def _inv_schur(G: jnp.ndarray) -> jnp.ndarray:
    """Recursive SPD inverse via Schur complements.

    Splits into halves down to a 3x3 (or smaller) closed-form base; the
    recursion is ~log2(n/3) levels of batched matmuls with a short
    dependency chain (batched matmuls, no serial column loops)."""
    n = G.shape[-1]
    if n <= 3:
        if n == 0:
            return G
        if n == 3:
            return _inv3(G)
        if n == 1:
            return 1.0 / G
        # n == 2 closed form
        a, b = G[..., 0, 0], G[..., 0, 1]
        c, d = G[..., 1, 0], G[..., 1, 1]
        det = a * d - b * c
        row0 = jnp.stack([d, -b], axis=-1)
        row1 = jnp.stack([-c, a], axis=-1)
        return jnp.stack([row0, row1], axis=-2) / det[..., None, None]
    # Split as evenly as possible with the first block a multiple of 3.
    m = max(3, (n // 2 + 2) // 3 * 3)
    A = G[..., :m, :m]
    B = G[..., :m, m:]
    C = G[..., m:, m:]
    Ainv = _inv_schur(A)
    AinvB = Ainv @ B
    S = C - jnp.swapaxes(B, -1, -2) @ AinvB  # Schur complement (SPD)
    Sinv = _inv_schur(S)
    TR = -AinvB @ Sinv
    TL = Ainv - TR @ jnp.swapaxes(AinvB, -1, -2)
    BL = jnp.swapaxes(TR, -1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Sinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def chol_blocked(H: jnp.ndarray, nb: int = 48):
    """Blocked right-looking Cholesky: (L, Dinv) with per-panel inverses.

    Panels of width ``nb`` are factorized with the trace-time-unrolled
    kernels; trailing updates are batched matmuls — the BLASFEO blocked
    algorithm expressed in XLA. Backward stable (unlike Schur-complement
    block inversion, which loses *all* accuracy beyond cond ~1e5 — measured).
    ``Dinv`` stacks the inverses of the diagonal blocks of L for reuse in
    substitution. ``H`` is padded internally to a multiple of ``nb``.
    """
    n = H.shape[-1]
    n_pad = -(-n // nb) * nb
    if n_pad != n:
        batch = H.shape[:-2]
        P = jnp.zeros(batch + (n_pad, n_pad), H.dtype)
        P = P.at[..., :n, :n].set(H)
        pad_eye = jnp.eye(n_pad - n, dtype=H.dtype)
        P = P.at[..., n:, n:].set(jnp.broadcast_to(pad_eye,
                                                   batch + (n_pad - n,) * 2))
        H = P
    k = n_pad // nb
    M = H
    Lcols = []
    Dinvs = []
    for j in range(k):
        j0 = j * nb
        Ljj = chol_unrolled(M[..., j0:j0 + nb, j0:j0 + nb])
        Dj = tri_lower_inv_unrolled(Ljj)
        Lij = M[..., j0 + nb:, j0:j0 + nb] @ jnp.swapaxes(Dj, -1, -2)
        M = (M.at[..., j0 + nb:, j0 + nb:]
             .add(-Lij @ jnp.swapaxes(Lij, -1, -2)))
        zeros_above = jnp.zeros(M.shape[:-2] + (j0, nb), H.dtype)
        Lcols.append(jnp.concatenate([zeros_above, Ljj, Lij], axis=-2))
        Dinvs.append(Dj)
    L = jnp.concatenate(Lcols, axis=-1)
    return L, jnp.stack(Dinvs, axis=-3), n


def tri_lower_inv_blocked(L: jnp.ndarray, Dinv: jnp.ndarray, nb: int = 48):
    """Explicit inverse of a blocked lower-triangular factor.

    Block forward substitution on the identity: column-block j of ``Linv``
    is ``-Dinv_i @ sum_k L_ik Linv_kj`` below the diagonal block. All
    matmuls, k(k-1)/2 of them.
    """
    n_pad = L.shape[-1]
    k = n_pad // nb
    # cols[i][j] = (nb, nb) block (i, j) of Linv, i >= j.
    cols = [[None] * k for _ in range(k)]
    for j in range(k):
        cols[j][j] = Dinv[..., j, :, :]
        for i in range(j + 1, k):
            acc = 0.0
            for p in range(j, i):
                Lip = L[..., i * nb:(i + 1) * nb, p * nb:(p + 1) * nb]
                acc = acc + Lip @ cols[p][j]
            cols[i][j] = -Dinv[..., i, :, :] @ acc
    zero = jnp.zeros(L.shape[:-2] + (nb, nb), L.dtype)
    rows = [jnp.concatenate([cols[i][j] if j <= i else zero
                             for j in range(k)], axis=-1) for i in range(k)]
    return jnp.concatenate(rows, axis=-2)


def spd_inverse(G: jnp.ndarray, refine: int = 1, nb: int = 48,
                method: str = 'schur') -> jnp.ndarray:
    """Explicit inverse of an SPD matrix.

    Two kernels, picked by ``method``:

    - ``'schur'`` (default): recursive Schur-complement block inversion —
      log-depth batched matmuls, the fastest shape for the small
      (nu ~ 12-32) Riccati-recursion inverses that dominate the hot path.
      Accuracy degrades past cond ~1e5 in f32; fine for the barrier-clipped
      Riccati IPM, certified by the f64 oracle tests.
    - ``'chol'``: unrolled (n <= 8) or blocked Cholesky, then
      ``X = Linv' Linv``. Backward stable: residual |XG - I| ~ cond(G)*eps,
      the optimum for an explicit inverse. Use for the condensed IPM's
      large barrier-augmented Hessians (cond >~ 1e8), where Schur loses
      all accuracy and where Newton ``refine`` steps measurably *grow*
      the large-eigenvalue residual (those call sites pass refine=0).

    ``refine`` Newton steps (X <- X(2I - GX)) square away the blocked-
    elimination error at moderate conditioning.
    """
    n = G.shape[-1]
    if n == 0:
        return G
    if n <= 3:
        X = _inv_schur(G)  # closed forms, exact up to roundoff
    elif method == 'schur':
        X = _inv_schur(G)
    elif n <= 8:
        L = chol_unrolled(G)
        Linv = tri_lower_inv_unrolled(L)
        X = jnp.swapaxes(Linv, -1, -2) @ Linv
    else:
        # Blocked: small panels keep the sequential dependency chain short
        # (the scalar-unrolled kernels are latency-bound); panel size grows
        # with n so the block matmuls stay large.
        nbk = 8 if n <= 64 else nb
        L, Dinv, _ = chol_blocked(G, nbk)
        Linv = tri_lower_inv_blocked(L, Dinv, nbk)
        X = (jnp.swapaxes(Linv, -1, -2) @ Linv)[..., :n, :n]
    eye2 = 2.0 * jnp.eye(n, dtype=G.dtype)
    for _ in range(refine):
        X = X @ (eye2 - G @ X)
    return 0.5 * (X + jnp.swapaxes(X, -1, -2))
