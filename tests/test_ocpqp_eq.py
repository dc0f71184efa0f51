"""IPM with stage equalities + inequalities.

Certification strategy: (a) with inert inequalities the IPM must reproduce
the exact equality-constrained Riccati solve; (b) with active inequalities,
verify optimality via the active-set oracle — refit an equality-constrained
QP with the IPM's claimed active rows pinned and require agreement (plus
feasibility and dual signs, this is a full KKT certificate).
"""

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.core.types import StageEquality
from cheeta_mpc.ops.ocpqp import IpmSettings, solve_ocp_qp
from cheeta_mpc.ops.riccati import solve_eq_lqr
from tests.problem_gen import add_random_constraints, random_lq_problem
from tests.test_riccati_eq import dense_solve_with_equalities, make_problem

SETTINGS = IpmSettings(iters=30)


def _with_eq(data, Ceq, Deq, h, mask):
    eq = StageEquality(C=jnp.asarray(Ceq), D=jnp.asarray(Deq),
                       e=jnp.asarray(-h), mask=jnp.asarray(mask))
    return data.replace(eq=eq)


def test_inert_inequalities_match_eq_lqr():
    data, Ceq, Deq, h, mask = make_problem(0, N=6, nx=5, nu=4, nc=2)
    rng = np.random.default_rng(1)
    data_c = add_random_constraints(rng, data, ng=3, tight=500.0)
    data_c = _with_eq(data_c, Ceq, Deq, h, mask)
    sol = solve_ocp_qp(data_c, SETTINGS)
    ref = solve_eq_lqr(_with_eq(data, Ceq, Deq, h, mask))
    np.testing.assert_allclose(np.asarray(sol.du), np.asarray(ref.du),
                               atol=1e-6)
    # Equalities hold.
    res = (np.einsum('kij,kj->ki', Ceq, np.asarray(sol.dx[:-1]))
           + np.einsum('kij,kj->ki', Deq, np.asarray(sol.du)) - h)
    assert np.abs(res * mask).max() < 1e-7


def _eq_feasible_ref(data_eq, rng, scale=1.0):
    """A dynamics+equality-feasible trajectory: eq-LQR with perturbed cost."""
    pert = data_eq.replace(cost=data_eq.cost.replace(
        q=data_eq.cost.q + scale * rng.normal(size=data_eq.cost.q.shape),
        r=data_eq.cost.r + scale * rng.normal(size=data_eq.cost.r.shape)))
    sol = solve_eq_lqr(pert)
    return np.asarray(sol.dx), np.asarray(sol.du)


def test_active_inequalities_with_equalities():
    data, Ceq, Deq, h, mask = make_problem(2, N=6, nx=5, nu=4, nc=2)
    rng = np.random.default_rng(3)
    data_eq = _with_eq(data, Ceq, Deq, h, mask)
    ref = _eq_feasible_ref(data_eq, rng, scale=3.0)
    data_c = add_random_constraints(rng, data, ng=3, tight=0.5, ref=ref)
    data_c = _with_eq(data_c, Ceq, Deq, h, mask)
    sol = solve_ocp_qp(data_c, SETTINGS)
    con = data_c.con
    mcon = np.asarray(con.mask)

    # Feasibility.
    du_pad = np.concatenate([np.asarray(sol.du), np.zeros((1, 4))])
    g = (np.einsum('nij,nj->ni', np.asarray(con.C), np.asarray(sol.dx))
         + np.einsum('nij,nj->ni', np.asarray(con.D), du_pad))
    viol = np.maximum(np.asarray(con.lg) - g, g - np.asarray(con.ug))
    assert (viol * mcon).max() < 1e-6
    res = (np.einsum('kij,kj->ki', Ceq, np.asarray(sol.dx[:-1]))
           + np.einsum('kij,kj->ki', Deq, np.asarray(sol.du)) - h)
    assert np.abs(res * mask).max() < 1e-7
    # Dual signs.
    assert float(jnp.min(sol.lam_l)) > -1e-9
    assert float(jnp.min(sol.lam_u)) > -1e-9

    # Active-set oracle: pin rows with significant duals as equalities and
    # refit with the dense equality solver; must agree with the IPM point.
    lam_l = np.asarray(sol.lam_l)
    lam_u = np.asarray(sol.lam_u)
    act_l = (lam_l > 1e-5) & (mcon > 0)
    act_u = (lam_u > 1e-5) & (mcon > 0)
    assert act_l.any() or act_u.any(), "weak instance: nothing active"
    N, nceq = 6, Ceq.shape[1]
    ng = 3
    # Build a combined equality system: original equalities + pinned rows.
    rows_C, rows_D, rows_h, rows_m = [], [], [], []
    for k in range(N):
        Cs, Ds, hs, ms = [Ceq[k]], [Deq[k]], [h[k]], [mask[k]]
        for j in range(ng):
            for act, bound in ((act_l, np.asarray(con.lg)),
                               (act_u, np.asarray(con.ug))):
                if act[k, j]:
                    Cs.append(np.asarray(con.C)[k, j][None])
                    Ds.append(np.asarray(con.D)[k, j][None])
                    hs.append(np.asarray([bound[k, j]]))
                    ms.append(np.asarray([1.0]))
        rows_C.append(np.vstack(Cs)); rows_D.append(np.vstack(Ds))
        rows_h.append(np.concatenate(hs)); rows_m.append(np.concatenate(ms))
    # Terminal-node active rows (state-only) appended to stage N-1? The
    # dense oracle only supports stage equalities on k<N; skip instances
    # with active terminal rows.
    if act_l[N].any() or act_u[N].any():
        import pytest
        pytest.skip("active terminal rows; oracle limited to stage rows")
    nc_max = max(c.shape[0] for c in rows_C)
    Ceq2 = np.zeros((N, nc_max, 5)); Deq2 = np.zeros((N, nc_max, 4))
    h2 = np.zeros((N, nc_max)); m2 = np.zeros((N, nc_max))
    for k in range(N):
        n_k = rows_C[k].shape[0]
        Ceq2[k, :n_k] = rows_C[k]; Deq2[k, :n_k] = rows_D[k]
        h2[k, :n_k] = rows_h[k]; m2[k, :n_k] = rows_m[k]
    dx_ref, du_ref = dense_solve_with_equalities(data, Ceq2, Deq2, h2, m2)
    np.testing.assert_allclose(np.asarray(sol.du), du_ref, atol=2e-4)


def test_vmap_eq():
    datas = []
    for seed in range(3):
        data, Ceq, Deq, h, mask = make_problem(seed, N=5, nx=4, nu=3, nc=2)
        rng = np.random.default_rng(seed + 10)
        ref = _eq_feasible_ref(_with_eq(data, Ceq, Deq, h, mask), rng)
        d = add_random_constraints(rng, data, ng=2, tight=0.6, ref=ref)
        datas.append(_with_eq(d, Ceq, Deq, h, mask))
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    sols = jax.jit(jax.vmap(lambda d: solve_ocp_qp(d, SETTINGS)))(batched)
    for i, d in enumerate(datas):
        ref = solve_ocp_qp(d, SETTINGS)
        np.testing.assert_allclose(np.asarray(sols.du[i]),
                                   np.asarray(ref.du), atol=1e-6)
