"""Swing-foot z-reference planning: cubic splines + per-phase CPG.

Re-creates the behavior of the reference's swing planner
(``ocs2_legged_robot/src/foot_planner/{CubicSpline,SplineCpg,
SwingTrajectoryPlanner}.cpp``): per swing phase, two Hermite cubics through a
mid-phase apex, with liftoff/touchdown velocities scaled by
``min(1, swingDuration / swingTimeScale)``; stance phases hold terrain
height. Defaults from the reference config loader
(SwingTrajectoryPlanner.cpp:229-252 / task.info): liftOffVelocity 0.2,
touchDownVelocity -0.4, swingHeight 0.1, swingTimeScale 0.15.

Spline evaluation is pure array math (vectorizes over (leg, time) grids);
schedule extraction is host-side. The product consumed by the jitted solver
is a pair of arrays ``(z_pos_ref, z_vel_ref)`` sampled on the shooting grid —
the constraint configs the reference injects per-node via PreComputation
(LeggedRobotPreComputation.cpp:44-88) become plain solver inputs here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from cheeta_mpc.gait.motion_phase import contact_flags_of_mode
from cheeta_mpc.gait.schedule import ModeSchedule


@dataclass
class CubicSpline:
    """Hermite cubic between (t0, p0, v0) and (t1, p1, v1), evaluated on
    normalized time (reference CubicSpline.cpp:38-80)."""

    t0: float
    t1: float
    p0: float
    v0: float
    p1: float
    v1: float

    def __post_init__(self):
        dt = self.t1 - self.t0
        dp = self.p1 - self.p0
        dv = self.v1 - self.v0
        self.dt = dt
        self.c0 = self.p0
        self.c1 = self.v0 * dt
        self.c2 = -(3.0 * self.v0 + dv) * dt + 3.0 * dp
        self.c3 = (2.0 * self.v0 + dv) * dt - 2.0 * dp

    def _tn(self, t):
        return (np.asarray(t) - self.t0) / self.dt

    def position(self, t):
        tn = self._tn(t)
        return ((self.c3 * tn + self.c2) * tn + self.c1) * tn + self.c0

    def velocity(self, t):
        tn = self._tn(t)
        return ((3.0 * self.c3 * tn + 2.0 * self.c2) * tn + self.c1) / self.dt

    def acceleration(self, t):
        tn = self._tn(t)
        return (6.0 * self.c3 * tn + 2.0 * self.c2) / (self.dt * self.dt)


@dataclass
class SplineCpg:
    """Two cubics split at the phase midpoint with zero-velocity apex
    (reference SplineCpg.cpp:39-66)."""

    lift_time: float
    lift_height: float
    lift_velocity: float
    mid_height: float
    touch_time: float
    touch_height: float
    touch_velocity: float

    def __post_init__(self):
        self.mid_time = 0.5 * (self.lift_time + self.touch_time)
        self.left = CubicSpline(self.lift_time, self.mid_time,
                                self.lift_height, self.lift_velocity,
                                self.mid_height, 0.0)
        self.right = CubicSpline(self.mid_time, self.touch_time,
                                 self.mid_height, 0.0,
                                 self.touch_height, self.touch_velocity)

    def position(self, t):
        t = np.asarray(t)
        return np.where(t < self.mid_time, self.left.position(t),
                        self.right.position(t))

    def velocity(self, t):
        t = np.asarray(t)
        return np.where(t < self.mid_time, self.left.velocity(t),
                        self.right.velocity(t))


def swing_trajectory_scaling(start: float, final: float,
                             swing_time_scale: float) -> float:
    """Down-scale apex/velocities for short swings (reference
    SwingTrajectoryPlanner.cpp swingTrajectoryScaling)."""
    return min(1.0, (final - start) / swing_time_scale)


@dataclass
class SwingConfig:
    lift_off_velocity: float = 0.2
    touch_down_velocity: float = -0.4
    swing_height: float = 0.1
    swing_time_scale: float = 0.15


class SwingTrajectoryPlanner:
    """Per-leg z-reference over a mode schedule.

    ``update`` rebuilds per-phase splines (reference
    SwingTrajectoryPlanner.cpp:78-122); ``z_position`` / ``z_velocity``
    evaluate the active phase's spline at arbitrary times; ``sample_grid``
    produces the (num_feet, horizon) arrays for the solver.
    """

    def __init__(self, config: SwingConfig = SwingConfig(), num_feet: int = 4):
        self.config = config
        self.num_feet = num_feet
        self._events: List[float] = []
        self._phases: List[List[SplineCpg]] = [[] for _ in range(num_feet)]

    def update(self, mode_schedule: ModeSchedule,
               terrain_height: float = 0.0) -> None:
        modes = mode_schedule.mode_sequence
        events = mode_schedule.event_times
        flags = contact_flags_of_mode(np.asarray(modes))  # (P, feet)
        num_phases = len(modes)
        self._events = list(events)
        cfg = self.config

        for leg in range(self.num_feet):
            leg_flags = flags[:, leg] > 0
            phases: List[SplineCpg] = []
            for p in range(num_phases):
                if leg_flags[p]:
                    # Stance: constant-height "spline".
                    phases.append(SplineCpg(0.0, terrain_height, 0.0,
                                            terrain_height, 1.0,
                                            terrain_height, 0.0))
                    continue
                # Swing: previous contact phase end -> next contact start.
                start_idx = -1
                for ip in range(p - 1, -1, -1):
                    if leg_flags[ip]:
                        start_idx = ip
                        break
                final_idx = num_phases - 2
                for ip in range(p + 1, num_phases):
                    if leg_flags[ip]:
                        final_idx = ip - 1
                        break
                if start_idx < 0:
                    raise ValueError(
                        f"leg {leg} starts in swing with no preceding "
                        f"liftoff event (phase {p})")
                t_lift = events[start_idx]
                t_touch = events[final_idx] if final_idx < len(events) else (
                    events[-1] + 1.0)
                s = swing_trajectory_scaling(t_lift, t_touch,
                                             cfg.swing_time_scale)
                phases.append(SplineCpg(
                    t_lift, terrain_height, s * cfg.lift_off_velocity,
                    terrain_height + s * cfg.swing_height,
                    t_touch, terrain_height, s * cfg.touch_down_velocity))
            self._phases[leg] = phases

    def _phase_index(self, t: float) -> int:
        import bisect
        return bisect.bisect_right(self._events, t)

    def z_position(self, leg: int, t: float) -> float:
        return float(self._phases[leg][self._phase_index(t)].position(t))

    def z_velocity(self, leg: int, t: float) -> float:
        return float(self._phases[leg][self._phase_index(t)].velocity(t))

    def sample_grid(self, t0: float, dt: float, horizon: int):
        """(z_pos, z_vel) arrays of shape (num_feet, horizon) on the
        shooting grid — solver inputs for the normal-velocity constraints."""
        return self.sample_times(t0 + np.arange(horizon) * dt)

    def sample_times(self, ts):
        """(z_pos, z_vel) of shape (num_feet, len(ts)) at arbitrary times —
        for event-aligned (non-uniform) shooting grids."""
        ts = np.asarray(ts, np.float64)
        z_pos = np.zeros((self.num_feet, len(ts)))
        z_vel = np.zeros((self.num_feet, len(ts)))
        for leg in range(self.num_feet):
            for k, t in enumerate(ts):
                z_pos[leg, k] = self.z_position(leg, float(t))
                z_vel[leg, k] = self.z_velocity(leg, float(t))
        return z_pos, z_vel
