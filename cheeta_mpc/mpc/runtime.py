"""MPC/MRT runtime: the real-time planner/tracker split.

Re-creates the capability surface of the reference's ``ocs2_mpc`` layer:

- :class:`MpcSettings` — mpc::Settings (reference MPC_Settings.h:43-71):
  timeHorizon, solutionTimeWindow, coldStart, debugPrint, frequencies.
- :class:`SystemObservation` — {mode, time, state, input}
  (reference SystemObservation.h).
- :class:`PolicyData` — the policy bundle the MPC hands to the tracker
  ({CommandData, PrimalSolution, PerformanceIndex} in the reference), now
  carrying the value function {P, p} and inequality duals so the query
  surface of the reference solver is reachable from the tracker side:
  ``value_at`` (reference MultipleShootingSolver::getValueFunction,
  MultipleShootingSolver.cpp:125-144 — interpolation + re-centering),
  ``feedback_gain_at`` (MPC_MRT_Interface::getLinearFeedbackGain,
  MPC_MRT_Interface.cpp:141-155) and ``dual_at``
  (getIntermediateDualSolution, :157-170).
- :class:`MrtObserver` — modifyBufferedSolution/modifyActiveSolution hooks
  invoked under the buffer lock (reference MrtObserver.h).
- :class:`MrtBase` — the double-buffered policy handoff
  (reference MRT_BASE.cpp:156-232): ``move_to_buffer`` fills the back buffer
  under a lock; ``update_policy`` try-locks and swaps buffer -> active with a
  starvation warning counter; ``evaluate_policy`` interpolates the active
  policy (feedforward + optional feedback K(x - x*)); ``rollout_policy``
  forward-integrates the active policy through a user plant model
  (reference MRT_BASE::rolloutPolicy, MRT_BASE.cpp:124-151).
- :class:`MpcMrtInterface` — single-process MPC+MRT
  (reference MPC_MRT_Interface.cpp:56-170): set observation, advance MPC
  (solve + window to solutionTimeWindow + buffer), query value function /
  gains / duals.
- :class:`DummyLoop` — closed-loop simulator with the reference's two modes
  (MRT_ROS_Dummy_Loop.cpp:76-164): deterministic lock-step ("synchronized",
  one MPC solve every ``mpc_update_ratio`` ticks, plant == model — the CI
  determinism trick SURVEY.md §4 calls out) and "realtime" (MPC advanced by
  wall-clock budget, policy consumed whenever fresh).

Host-side orchestration lives here; the solve itself is one jitted device
program. Device->host traffic per MPC step is only the policy buffer
(u_traj, x_traj, K, P, p), matching SURVEY.md §7's real-time-path guidance.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class MpcSettings:
    """Reference mpc::Settings (MPC_Settings.h:43-71, loader
    MPC_Settings.cpp:39-67). Frequencies are loop targets, consumed by the
    dummy loop / transport layers."""

    time_horizon: float = 1.0  # timeHorizon_
    solution_time_window: float = -1.0  # -1 => full horizon
    cold_start: bool = False  # coldStart_
    debug_print: bool = False
    mpc_desired_frequency: float = -1.0  # Hz; <0 => unconstrained
    mrt_desired_frequency: float = 400.0  # Hz

    @classmethod
    def from_task_info(cls, task_info_path: str) -> "MpcSettings":
        from cheeta_mpc.utils.info_config import load_info
        t = load_info(task_info_path)["mpc"]
        return cls(
            time_horizon=float(t.get("timeHorizon", 1.0)),
            solution_time_window=float(t.get("solutionTimeWindow", -1.0)),
            cold_start=str(t.get("coldStart", "false")).lower() == "true",
            debug_print=str(t.get("debugPrint", "false")).lower() == "true",
            mpc_desired_frequency=float(t.get("mpcDesiredFrequency", -1.0)),
            mrt_desired_frequency=float(t.get("mrtDesiredFrequency", 400.0)))


@dataclass
class SystemObservation:
    """Reference ocs2::SystemObservation (SystemObservation.h)."""

    time: float
    state: np.ndarray
    input: Optional[np.ndarray] = None
    mode: int = 15


@dataclass
class PolicyData:
    """One MPC policy: time-stamped open-loop trajectories + optional
    feedback gains, value function and duals (the reference's PrimalSolution
    + LinearController + the solver query surface)."""

    times: np.ndarray  # (N+1,) node times
    x_traj: np.ndarray  # (N+1, nx)
    u_traj: np.ndarray  # (N, nu)
    K: Optional[np.ndarray] = None  # (N, nu, nx) Riccati feedback
    P: Optional[np.ndarray] = None  # (N+1, nx, nx) value-function Hessians
    p: Optional[np.ndarray] = None  # (N+1, nx) value-function gradients
    lam_l: Optional[np.ndarray] = None  # (N+1, ng) lower inequality duals
    lam_u: Optional[np.ndarray] = None  # (N+1, ng) upper inequality duals
    init_observation: Optional[SystemObservation] = None
    performance: Optional[dict] = None

    def interp_state(self, t: float) -> np.ndarray:
        return _interp_rows(self.times, self.x_traj, t)

    def evaluate(self, t: float, x: Optional[np.ndarray] = None) -> np.ndarray:
        """Policy input at time t: feedforward (+ K(x - x*) when gains and a
        measured state are available) — reference MRT_BASE::evaluatePolicy
        (MRT_BASE.cpp:104-119)."""
        idx = self._input_index(t)
        u = self.u_traj[idx].copy()
        if self.K is not None and x is not None:
            u = u + self.K[idx] @ (x - self.interp_state(t))
        return u

    def _input_index(self, t: float) -> int:
        tu = self.times[:-1]
        return int(np.clip(np.searchsorted(tu, t, side='right') - 1, 0,
                           len(tu) - 1))

    def value_at(self, t: float, x: np.ndarray) -> float:
        """Quadratic value function at (t, x), re-centered on the stored
        trajectory: V = 1/2 dx' P(t) dx + p(t)' dx with dx = x - x*(t)
        (reference MultipleShootingSolver::getValueFunction,
        MultipleShootingSolver.cpp:125-144)."""
        if self.P is None or self.p is None:
            raise RuntimeError("policy has no value function "
                               "(solver createValueFunction off)")
        P = _interp_rows(self.times, self.P, t)
        p = _interp_rows(self.times, self.p, t)
        dx = np.asarray(x, np.float64) - self.interp_state(t)
        return float(0.5 * dx @ P @ dx + p @ dx)

    def feedback_gain_at(self, t: float) -> np.ndarray:
        """K at the active node (reference
        MPC_MRT_Interface::getLinearFeedbackGain, MPC_MRT_Interface.cpp:
        141-155 — nearest-node lookup, gains are piecewise constant)."""
        if self.K is None:
            raise RuntimeError("policy has no feedback gains")
        return self.K[self._input_index(t)]

    def dual_at(self, t: float) -> dict:
        """Inequality duals at the active node (reference
        getIntermediateDualSolution, MPC_MRT_Interface.cpp:157-170)."""
        if self.lam_l is None or self.lam_u is None:
            raise RuntimeError("policy has no dual solution")
        k = self._input_index(t)
        return {"lam_l": self.lam_l[k], "lam_u": self.lam_u[k]}

    def windowed(self, window: float) -> "PolicyData":
        """Truncate to [t0, t0 + window] (reference solutionTimeWindow
        behavior, MPC_MRT_Interface.cpp:78-136). window <= 0 => full."""
        if window <= 0 or self.times[-1] - self.times[0] <= window:
            return self
        t_end = self.times[0] + window
        n = int(np.searchsorted(self.times, t_end, side='left')) + 1
        n = max(2, min(n, len(self.times)))

        def cut(a, m):
            return None if a is None else a[:m]

        return PolicyData(
            times=self.times[:n], x_traj=self.x_traj[:n],
            u_traj=self.u_traj[:n - 1], K=cut(self.K, n - 1),
            P=cut(self.P, n), p=cut(self.p, n),
            lam_l=cut(self.lam_l, n), lam_u=cut(self.lam_u, n),
            init_observation=self.init_observation,
            performance=self.performance)


def _interp_rows(ts: np.ndarray, rows: np.ndarray, t: float) -> np.ndarray:
    t = float(np.clip(t, ts[0], ts[-1]))
    i = int(np.clip(np.searchsorted(ts, t, side='right') - 1, 0,
                    len(ts) - 2))
    w = (t - ts[i]) / max(ts[i + 1] - ts[i], 1e-12)
    return (1 - w) * rows[i] + w * rows[i + 1]


def shift_warm_start(policy: PolicyData, times_new: np.ndarray):
    """Warm start for the next MPC tick from the previous policy: states
    linearly interpolated onto the new grid, inputs zero-order-held
    (reference MultipleShootingSolver::initializeStateInputTrajectories,
    MultipleShootingSolver.cpp:229-265 — interpolate where the previous
    solution overlaps, extrapolate-by-hold beyond it).

    Returns (x_init (M, nx), u_init (M-1, nu)) for the solver's ``warm=``
    argument."""
    times_new = np.asarray(times_new, np.float64)
    x_init = np.stack([_interp_rows(policy.times, policy.x_traj, float(t))
                       for t in times_new])
    tu = policy.times[:-1]
    idx = np.clip(np.searchsorted(tu, times_new[:-1], side='right') - 1, 0,
                  len(tu) - 1)
    u_init = policy.u_traj[idx]
    return x_init, u_init


class MrtObserver:
    """Mutation/observation hooks invoked under the buffer lock (reference
    MrtObserver.h: modifyBufferedSolution at fill time, modifyActiveSolution
    at swap time). Override either; default is a no-op."""

    def modify_buffered_solution(self, policy: PolicyData) -> None:
        pass

    def modify_active_solution(self, policy: PolicyData) -> None:
        pass


class MrtBase:
    """Double-buffered wait-free policy consumption
    (reference MRT_BASE.cpp:156-210)."""

    def __init__(self) -> None:
        self._buffer_lock = threading.Lock()
        self._buffer: Optional[PolicyData] = None
        self._active: Optional[PolicyData] = None
        self._new_policy_in_buffer = False
        self.trylock_failures = 0  # starvation warning counter (:172-179)
        self.observers: List[Callable[[PolicyData], None]] = []
        self.mrt_observers: List[MrtObserver] = []

    @property
    def initial_policy_received(self) -> bool:
        return self._active is not None or self._new_policy_in_buffer

    def move_to_buffer(self, policy: PolicyData) -> None:
        with self._buffer_lock:
            for mo in self.mrt_observers:
                mo.modify_buffered_solution(policy)
            self._buffer = policy
            self._new_policy_in_buffer = True
        for obs in self.observers:
            obs(policy)

    def update_policy(self) -> bool:
        """Try-lock swap buffer -> active; returns True if a fresh policy was
        activated."""
        acquired = self._buffer_lock.acquire(blocking=False)
        if not acquired:
            self.trylock_failures += 1
            return False
        try:
            if not self._new_policy_in_buffer:
                return False
            self._active, self._buffer = self._buffer, self._active
            self._new_policy_in_buffer = False
            for mo in self.mrt_observers:
                mo.modify_active_solution(self._active)
            return True
        finally:
            self._buffer_lock.release()

    def evaluate_policy(self, t: float,
                        x: Optional[np.ndarray] = None) -> np.ndarray:
        if self._active is None:
            raise RuntimeError("no policy received yet")
        return self._active.evaluate(t, x)

    def rollout_policy(self, t0: float, x0: np.ndarray, rollout_dt: float,
                       n_steps: int,
                       plant_step: Callable[[float, np.ndarray, np.ndarray],
                                            np.ndarray]):
        """Forward-integrate the active policy through ``plant_step``
        (reference MRT_BASE::rolloutPolicy, MRT_BASE.cpp:124-151 — there via
        RolloutBase; here the integrator is supplied by the caller).

        Returns (times (n+1,), states (n+1, nx), inputs (n, nu))."""
        if self._active is None:
            raise RuntimeError("no policy received yet")
        t = float(t0)
        x = np.asarray(x0, np.float64).copy()
        times, states, inputs = [t], [x.copy()], []
        for _ in range(n_steps):
            u = self._active.evaluate(t, x)
            x = np.asarray(plant_step(t, x, u), np.float64)
            t += rollout_dt
            times.append(t)
            states.append(x.copy())
            inputs.append(u)
        return (np.asarray(times), np.stack(states), np.stack(inputs))

    @property
    def active_policy(self) -> Optional[PolicyData]:
        return self._active


class MpcMrtInterface(MrtBase):
    """Single-process MPC + MRT (reference MPC_MRT_Interface.cpp).

    ``solve_fn(observation) -> PolicyData`` wraps the jitted solver plus its
    reference/gait plumbing (supplied by the application layer).
    """

    def __init__(self, solve_fn: Callable[[SystemObservation], PolicyData],
                 settings: Optional[MpcSettings] = None):
        super().__init__()
        self._solve_fn = solve_fn
        self.settings = settings or MpcSettings()
        self._obs_lock = threading.Lock()
        self._observation: Optional[SystemObservation] = None
        self.solve_count = 0

    def set_current_observation(self, obs: SystemObservation) -> None:
        with self._obs_lock:
            self._observation = obs

    def advance_mpc(self) -> PolicyData:
        with self._obs_lock:
            obs = self._observation
        if obs is None:
            raise RuntimeError("no observation set")
        policy = self._solve_fn(obs)
        policy.init_observation = obs
        policy = policy.windowed(self.settings.solution_time_window)
        self.move_to_buffer(policy)
        self.solve_count += 1
        return policy

    # --- solver query surface (reference MPC_MRT_Interface.cpp:141-170) ----
    def get_value_function(self, t: float, x: np.ndarray) -> float:
        if self._active is None:
            raise RuntimeError("no policy received yet")
        return self._active.value_at(t, x)

    def get_linear_feedback_gain(self, t: float) -> np.ndarray:
        if self._active is None:
            raise RuntimeError("no policy received yet")
        return self._active.feedback_gain_at(t)

    def get_intermediate_dual_solution(self, t: float) -> dict:
        if self._active is None:
            raise RuntimeError("no policy received yet")
        return self._active.dual_at(t)


@dataclass
class DummyLoopResult:
    times: np.ndarray
    states: np.ndarray
    inputs: np.ndarray
    solves: int
    # Realtime mode: solver exceptions raised in the MPC worker thread. The
    # reference treats a failed solve as fatal (NAN_SOL throw,
    # MultipleShootingSolver.cpp:283-285); the realtime loop keeps ticking on
    # the last good policy but records the failures so a run that never
    # replanned cannot read as healthy. Lock-step mode propagates instead.
    solve_errors: int = 0
    first_error: Optional[str] = None


def run_dummy_loop(interface: MpcMrtInterface,
                   plant_step: Callable[[float, np.ndarray, np.ndarray],
                                        np.ndarray],
                   x0: np.ndarray,
                   mrt_dt: float,
                   mpc_update_ratio: int,
                   n_steps: int,
                   use_feedback: bool = True) -> DummyLoopResult:
    """Deterministic lock-step closed loop (reference
    MRT_ROS_Dummy_Loop.cpp:76-129 synchronized mode): one MPC solve every
    ``mpc_update_ratio`` MRT ticks, plant == model via ``plant_step``."""
    t = 0.0
    x = np.asarray(x0, dtype=np.float64).copy()
    times, states, inputs = [t], [x.copy()], []

    interface.set_current_observation(SystemObservation(time=t, state=x))
    interface.advance_mpc()
    assert interface.update_policy()

    for step in range(n_steps):
        if step > 0 and step % mpc_update_ratio == 0:
            interface.set_current_observation(
                SystemObservation(time=t, state=x))
            interface.advance_mpc()
            interface.update_policy()
        u = interface.evaluate_policy(t, x if use_feedback else None)
        x = plant_step(t, x, u)
        t += mrt_dt
        times.append(t)
        states.append(x.copy())
        inputs.append(u)
    return DummyLoopResult(times=np.asarray(times), states=np.stack(states),
                           inputs=np.stack(inputs),
                           solves=interface.solve_count)


def run_realtime_dummy_loop(interface: MpcMrtInterface,
                            plant_step: Callable[[float, np.ndarray,
                                                  np.ndarray], np.ndarray],
                            x0: np.ndarray,
                            mrt_dt: float,
                            n_steps: int,
                            use_feedback: bool = True,
                            realtime_factor: float = 0.0) -> DummyLoopResult:
    """Realtime mode (reference MRT_ROS_Dummy_Loop.cpp:133-164): the MPC
    runs in a worker thread as fast as observations arrive; the MRT loop
    ticks at mrt_dt consuming whatever policy is freshest. With
    ``realtime_factor > 0`` the loop sleeps to approximate wall-clock pacing;
    at 0 it free-runs (still non-deterministic, but fast for tests)."""
    import time as _time

    t = 0.0
    x = np.asarray(x0, dtype=np.float64).copy()
    times, states, inputs = [t], [x.copy()], []

    interface.set_current_observation(SystemObservation(time=t, state=x))
    interface.advance_mpc()
    assert interface.update_policy()

    stop = threading.Event()
    errors = {"count": 0, "first": None}

    def mpc_worker():
        while not stop.is_set():
            try:
                interface.advance_mpc()
            except Exception as e:  # noqa: BLE001 — recorded, not swallowed
                if errors["first"] is None:
                    errors["first"] = f"{type(e).__name__}: {e}"
                    import logging
                    logging.getLogger(__name__).warning(
                        "MPC worker solve failed (policy frozen at last "
                        "good solution): %s", errors["first"])
                errors["count"] += 1

    worker = threading.Thread(target=mpc_worker, daemon=True)
    worker.start()
    try:
        for _ in range(n_steps):
            interface.set_current_observation(
                SystemObservation(time=t, state=x))
            interface.update_policy()
            u = interface.evaluate_policy(t, x if use_feedback else None)
            x = plant_step(t, x, u)
            t += mrt_dt
            times.append(t)
            states.append(x.copy())
            inputs.append(u)
            if realtime_factor > 0:
                _time.sleep(mrt_dt / realtime_factor)
    finally:
        stop.set()
        worker.join(timeout=5.0)
    return DummyLoopResult(times=np.asarray(times), states=np.stack(states),
                           inputs=np.stack(inputs),
                           solves=interface.solve_count,
                           solve_errors=errors["count"],
                           first_error=errors["first"])
