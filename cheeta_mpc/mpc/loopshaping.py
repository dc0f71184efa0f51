"""Loopshaping observation conversion.

The capability equivalent of the reference's ``LoopshapingSystemObservation``
(`/root/reference/ocs2_mpc/src/LoopshapingSystemObservation.cpp:31-42`) and
``LoopshapingDummyObserver`` (`ocs2_ros_interfaces/src/mrt/
LoopshapingDummyObserver.cpp`): when the OCP is solved in *loopshaping*
coordinates — the system state augmented with input-filter states
``x_aug = [x_sys, x_filter]`` and the filtered input ``u_aug`` — downstream
consumers (visualizers, loggers, system observers) need observations in the
original system coordinates.

The reference delegates the coordinate maps to ocs2_core's
``LoopshapingDefinition``; here the definition is the minimal data those maps
need (dimensions + the filter's output map ``u_sys = C_f x_filter + D_f
u_aug``), covering the reference's output-filter ("r-filter"/"s-filter")
configurations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from cheeta_mpc.mpc.runtime import SystemObservation


@dataclass
class LoopshapingDefinition:
    """Minimal loopshaping coordinate description.

    x_aug = [x_sys (nx_sys), x_filter (nf)];
    u_sys = C_f @ x_filter + D_f @ u_aug  (ocs2 s-filter convention;
    with nf = 0 and D_f = I this is the identity loopshaping)."""

    nx_sys: int
    nf: int = 0
    C_f: Optional[np.ndarray] = None  # (nu_sys, nf)
    D_f: Optional[np.ndarray] = None  # (nu_sys, nu_aug)

    def system_state(self, x_aug: np.ndarray) -> np.ndarray:
        return np.asarray(x_aug)[..., :self.nx_sys]

    def filter_state(self, x_aug: np.ndarray) -> np.ndarray:
        return np.asarray(x_aug)[..., self.nx_sys:self.nx_sys + self.nf]

    def system_input(self, x_aug: np.ndarray,
                     u_aug: Optional[np.ndarray]) -> Optional[np.ndarray]:
        if u_aug is None:
            return None
        u_aug = np.asarray(u_aug)
        u = u_aug if self.D_f is None else self.D_f @ u_aug
        if self.nf and self.C_f is not None:
            u = u + self.C_f @ self.filter_state(x_aug)
        return u


def loopshaping_to_system_observation(
        defn: LoopshapingDefinition,
        obs: SystemObservation) -> SystemObservation:
    """Reference LoopshapingSystemObservation::loopshapingToSystemObservation
    (LoopshapingSystemObservation.cpp:31-42): strip filter states, map the
    input back through the filter's output equation; time/mode unchanged."""
    return SystemObservation(
        time=obs.time,
        state=defn.system_state(obs.state),
        input=defn.system_input(obs.state, obs.input),
        mode=obs.mode)


class LoopshapingObserver:
    """Reference LoopshapingDummyObserver: wraps observers that expect
    system-coordinate observations and feeds them converted ones."""

    def __init__(self, defn: LoopshapingDefinition, observers: List):
        self._defn = defn
        self._observers = list(observers)

    def update(self, obs: SystemObservation, *args, **kwargs) -> None:
        sys_obs = loopshaping_to_system_observation(self._defn, obs)
        for o in self._observers:
            o.update(sys_obs, *args, **kwargs)
