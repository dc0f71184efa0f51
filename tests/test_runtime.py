"""MPC/MRT runtime: buffer handoff semantics + lock-step closed loop on a
toy LQR plant (keeps the heavy centroidal solve out of this unit)."""

import numpy as np

from cheeta_mpc.mpc.runtime import (MpcMrtInterface, MrtBase, PolicyData,
                                    SystemObservation, run_dummy_loop,
                                    run_realtime_dummy_loop)


def _toy_policy(t0, x0, N=10, dt=0.1):
    """Discrete double integrator driven toward the origin by an LQR-ish
    hand-rolled policy: x = [pos, vel], u = accel."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.0], [dt]])
    K = np.array([[-0.8, -1.2]])  # stabilizing gains
    xs, us = [np.asarray(x0, float)], []
    for _ in range(N):
        u = K @ xs[-1]
        us.append(u)
        xs.append(A @ xs[-1] + B @ u)
    times = t0 + dt * np.arange(N + 1)
    return PolicyData(times=times, x_traj=np.stack(xs), u_traj=np.stack(us),
                      K=np.tile(K[None], (N, 1, 1)))


def test_double_buffer_swap():
    mrt = MrtBase()
    assert not mrt.initial_policy_received
    p1 = _toy_policy(0.0, [1.0, 0.0])
    mrt.move_to_buffer(p1)
    assert mrt.initial_policy_received
    assert mrt.update_policy()
    assert mrt.active_policy is p1
    # No new policy: swap refuses.
    assert not mrt.update_policy()
    p2 = _toy_policy(0.5, [0.5, 0.0])
    mrt.move_to_buffer(p2)
    assert mrt.update_policy()
    assert mrt.active_policy is p2


def test_policy_evaluation_feedback():
    p = _toy_policy(0.0, [1.0, 0.0])
    u_ff = p.evaluate(0.0)
    # Feedback correction K (x - x*) on a perturbed state.
    x_pert = p.x_traj[0] + np.array([0.1, 0.0])
    u_fb = p.evaluate(0.0, x_pert)
    np.testing.assert_allclose(u_fb - u_ff, p.K[0] @ np.array([0.1, 0.0]),
                               atol=1e-12)


def test_observer_fanout():
    mrt = MrtBase()
    seen = []
    mrt.observers.append(lambda pol: seen.append(pol))
    p = _toy_policy(0.0, [1.0, 0.0])
    mrt.move_to_buffer(p)
    assert seen == [p]


def test_lockstep_dummy_loop_regulates():
    dt = 0.1
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.0], [dt]])

    def solve_fn(obs: SystemObservation) -> PolicyData:
        return _toy_policy(obs.time, obs.state, dt=dt)

    def plant_step(t, x, u):
        return A @ x + B @ u

    iface = MpcMrtInterface(solve_fn)
    res = run_dummy_loop(iface, plant_step, x0=[1.0, 0.0], mrt_dt=dt,
                         mpc_update_ratio=5, n_steps=60)
    assert res.solves == 1 + 11  # initial + one per 5 ticks (steps 5..55)
    # The closed loop regulates the state to near the origin.
    assert np.linalg.norm(res.states[-1]) < 0.05
    assert np.isfinite(res.inputs).all()


def test_realtime_loop_happy_path_has_zero_solve_errors():
    dt = 0.05
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.0], [dt]])
    iface = MpcMrtInterface(
        lambda obs: _toy_policy(obs.time, obs.state, dt=dt))
    res = run_realtime_dummy_loop(iface, lambda t, x, u: A @ x + B @ u,
                                  x0=[1.0, 0.0], mrt_dt=dt, n_steps=40)
    assert res.solve_errors == 0 and res.first_error is None
    assert res.solves >= 1
    assert np.isfinite(res.inputs).all()


def test_realtime_loop_records_solver_failures():
    """A solver that throws after the initial solve must not read as a
    healthy run: the loop keeps ticking on the frozen policy but the result
    records the failure count and message (reference parity: NAN_SOL is
    fatal, MultipleShootingSolver.cpp:283-285)."""
    dt = 0.05
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.0], [dt]])
    calls = {"n": 0}

    def solve_fn(obs):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("synthetic NAN_SOL")
        return _toy_policy(obs.time, obs.state, dt=dt)

    iface = MpcMrtInterface(solve_fn)
    res = run_realtime_dummy_loop(iface, lambda t, x, u: A @ x + B @ u,
                                  x0=[1.0, 0.0], mrt_dt=dt, n_steps=20)
    assert res.solve_errors > 0
    assert "synthetic NAN_SOL" in res.first_error
    assert res.solves == 1  # only the initial solve landed a policy


def test_lockstep_is_deterministic():
    dt = 0.1
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.0], [dt]])

    def make():
        iface = MpcMrtInterface(
            lambda obs: _toy_policy(obs.time, obs.state, dt=dt))
        return run_dummy_loop(iface, lambda t, x, u: A @ x + B @ u,
                              x0=[1.0, 0.0], mrt_dt=dt, mpc_update_ratio=4,
                              n_steps=40)

    r1, r2 = make(), make()
    np.testing.assert_array_equal(r1.states, r2.states)
    np.testing.assert_array_equal(r1.inputs, r2.inputs)
