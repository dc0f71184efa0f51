"""Solver observers: constraint-multiplier / metrics streaming.

The capability equivalent of the reference's augmented-Lagrangian observer
callbacks (`/root/reference/ocs2_ros_interfaces/src/synchronized_module/
RosAugmentedLagrangianCallbacks.cpp:40-77`: per-solve publication of a
constraint term's penalty metrics and Lagrange multipliers at fixed horizon
offsets, with nearest/linear interpolation in time). Without ROS, the
observer records the sampled series host-side; any transport (JSONL stream,
npz, bus topic) can fan it out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Sequence

import numpy as np

from cheeta_mpc.mpc.runtime import PolicyData


@dataclass
class MultiplierSample:
    solve_time: float  # time of the policy's first node
    offsets: np.ndarray  # (n_offsets,) seconds ahead of solve_time
    lam_l: np.ndarray  # (n_offsets, ng) lower-bound multipliers
    lam_u: np.ndarray  # (n_offsets, ng) upper-bound multipliers
    penalty: np.ndarray  # (n_offsets,) sum |multiplier| (merit contribution)


@dataclass
class ConstraintMultiplierObserver:
    """Samples inequality multipliers of every buffered policy at fixed
    horizon offsets (the reference's `fixed horizon offsets` + interpolation
    choice, RosAugmentedLagrangianCallbacks.cpp:40-77).

    Hook into MrtBase: ``mrt.observers.append(observer)``."""

    time_offsets: Sequence[float] = (0.0,)
    interpolation: Literal["nearest", "linear"] = "nearest"
    samples: List[MultiplierSample] = field(default_factory=list)

    def __call__(self, policy: PolicyData) -> None:
        if policy.lam_l is None or policy.lam_u is None:
            return
        t0 = float(policy.times[0])
        offs = np.asarray(self.time_offsets, np.float64)
        lam_l = np.stack([self._at(policy, policy.lam_l, t0 + o)
                          for o in offs])
        lam_u = np.stack([self._at(policy, policy.lam_u, t0 + o)
                          for o in offs])
        self.samples.append(MultiplierSample(
            solve_time=t0, offsets=offs, lam_l=lam_l, lam_u=lam_u,
            penalty=np.abs(lam_l).sum(axis=-1) + np.abs(lam_u).sum(axis=-1)))

    def _at(self, policy: PolicyData, rows: np.ndarray, t: float):
        ts = policy.times[:rows.shape[0]]
        if self.interpolation == "nearest":
            i = int(np.argmin(np.abs(ts - t)))
            return np.asarray(rows[i], np.float64)
        t = float(np.clip(t, ts[0], ts[-1]))
        i = int(np.clip(np.searchsorted(ts, t, side="right") - 1, 0,
                        len(ts) - 2))
        w = (t - ts[i]) / max(ts[i + 1] - ts[i], 1e-12)
        return np.asarray((1 - w) * rows[i] + w * rows[i + 1], np.float64)
