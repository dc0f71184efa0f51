"""Value-function / feedback-gain / dual query surface.

Two layers of certification:

1. **LQ value-function identity** (the reference's strongest Riccati oracle,
   testValuefunction.cpp:40-110): on a random unconstrained LQ problem the
   solver's cost-to-go {P, p} must satisfy, for any perturbed initial state,
   ``V(x0 + d) - V(x0) == p' d + 1/2 d' P d`` exactly, where V is evaluated
   by re-solving the LQ problem from the perturbed state.

2. **Query surface semantics** (reference MultipleShootingSolver.cpp:125-144
   + MPC_MRT_Interface.cpp:141-170): PolicyData.value_at interpolates +
   re-centers; feedback_gain_at / dual_at index the active node; the
   MpcMrtInterface accessors proxy the active policy.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.core.types import CostApprox, DynamicsLin, OcpQpData
from cheeta_mpc.mpc.runtime import (MpcMrtInterface, MpcSettings,
                                    PolicyData, SystemObservation)
from cheeta_mpc.ops.riccati import cost_of, solve_lqr
from tests.problem_gen import random_lq_problem


def test_lq_value_function_identity():
    """testValuefunction.cpp analogue at 1e-9."""
    rng = np.random.default_rng(3)
    data = random_lq_problem(rng, N=12, nx=6, nu=3)
    sol = solve_lqr(data)
    P0 = np.asarray(sol.gains.P[0])
    p0 = np.asarray(sol.gains.p[0])

    def total_cost_from(dx0):
        d = data.replace(dx0=jnp.asarray(dx0, jnp.float64))
        s = solve_lqr(d)
        return float(cost_of(data.cost, s.dx, s.du))

    v_base = total_cost_from(np.asarray(data.dx0))
    for _ in range(5):
        d = 0.3 * rng.standard_normal(6)
        v_pert = total_cost_from(np.asarray(data.dx0) + d)
        quad = float(p0 @ d + 0.5 * d @ P0 @ d)
        # p0 is the gradient at dx0 = the solver's expansion point; with
        # dx0 != 0 the gradient shifts by P0 dx0.
        grad_shift = float((P0 @ np.asarray(data.dx0)) @ d)
        assert abs((v_pert - v_base) - (quad + grad_shift)) < 1e-9


def _policy_with_value(N=8, nx=3, nu=2, dt=0.1):
    rng = np.random.default_rng(5)
    times = dt * np.arange(N + 1)
    x = rng.standard_normal((N + 1, nx))
    u = rng.standard_normal((N, nu))
    K = rng.standard_normal((N, nu, nx))
    P = np.stack([np.eye(nx) * (1.0 + k) for k in range(N + 1)])
    p = rng.standard_normal((N + 1, nx))
    lam_l = rng.random((N + 1, 4))
    lam_u = rng.random((N + 1, 4))
    return PolicyData(times=times, x_traj=x, u_traj=u, K=K, P=P, p=p,
                      lam_l=lam_l, lam_u=lam_u)


def test_value_at_recentering():
    pol = _policy_with_value()
    # At a node, with x == x*, V = 0 (pure re-centering).
    t = float(pol.times[3])
    assert pol.value_at(t, pol.x_traj[3]) == pytest.approx(0.0, abs=1e-12)
    # Perturbed: quadratic form with the node's P, p.
    d = np.array([0.1, -0.2, 0.05])
    expect = 0.5 * d @ pol.P[3] @ d + pol.p[3] @ d
    assert pol.value_at(t, pol.x_traj[3] + d) == pytest.approx(expect,
                                                               abs=1e-12)
    # Between nodes: P, p, x* all linearly interpolated.
    tm = 0.5 * (pol.times[3] + pol.times[4])
    Pm = 0.5 * (pol.P[3] + pol.P[4])
    pm = 0.5 * (pol.p[3] + pol.p[4])
    xm = 0.5 * (pol.x_traj[3] + pol.x_traj[4])
    expect = 0.5 * d @ Pm @ d + pm @ d
    assert pol.value_at(tm, xm + d) == pytest.approx(expect, abs=1e-12)


def test_gain_and_dual_queries():
    pol = _policy_with_value()
    np.testing.assert_array_equal(pol.feedback_gain_at(0.25), pol.K[2])
    duals = pol.dual_at(0.25)
    np.testing.assert_array_equal(duals["lam_l"], pol.lam_l[2])
    np.testing.assert_array_equal(duals["lam_u"], pol.lam_u[2])


def test_interface_accessors_and_window():
    pol = _policy_with_value()

    def solve_fn(obs):
        return _policy_with_value()

    itf = MpcMrtInterface(solve_fn,
                          MpcSettings(solution_time_window=0.35))
    itf.set_current_observation(SystemObservation(time=0.0,
                                                  state=pol.x_traj[0]))
    itf.advance_mpc()
    assert itf.update_policy()
    active = itf.active_policy
    # solutionTimeWindow truncation: 0.35 s at dt 0.1 -> nodes 0..4.
    assert active.times[-1] <= 0.4 + 1e-12
    assert len(active.times) == 5
    assert active.u_traj.shape[0] == 4
    # Accessors proxy the active policy.
    g = itf.get_linear_feedback_gain(0.15)
    np.testing.assert_array_equal(g, active.K[1])
    v = itf.get_value_function(0.0, active.x_traj[0])
    assert v == pytest.approx(0.0, abs=1e-12)
    d = itf.get_intermediate_dual_solution(0.15)
    np.testing.assert_array_equal(d["lam_l"], active.lam_l[1])


def test_mrt_observer_hooks():
    from cheeta_mpc.mpc.runtime import MrtBase, MrtObserver

    calls = []

    class Obs(MrtObserver):
        def modify_buffered_solution(self, policy):
            calls.append("buffered")
            policy.performance = {"tag": 1}

        def modify_active_solution(self, policy):
            calls.append("active")

    mrt = MrtBase()
    mrt.mrt_observers.append(Obs())
    pol = _policy_with_value()
    mrt.move_to_buffer(pol)
    assert calls == ["buffered"]
    assert pol.performance == {"tag": 1}
    assert mrt.update_policy()
    assert calls == ["buffered", "active"]


def test_rollout_policy():
    from cheeta_mpc.mpc.runtime import MrtBase

    pol = _policy_with_value()
    mrt = MrtBase()
    mrt.move_to_buffer(pol)
    assert mrt.update_policy()

    def plant(t, x, u):
        return x + 0.1 * np.concatenate([u, [0.0]])

    times, states, inputs = mrt.rollout_policy(0.0, pol.x_traj[0], 0.1, 5,
                                               plant)
    assert times.shape == (6,)
    assert states.shape == (6, 3)
    assert inputs.shape == (5, 2)
    # First input is the policy's evaluation at t=0 with feedback.
    np.testing.assert_allclose(inputs[0], pol.evaluate(0.0, pol.x_traj[0]))
