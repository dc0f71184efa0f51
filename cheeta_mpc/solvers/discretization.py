"""Event-aware time discretization for multiple shooting.

Host-side re-creation of the reference's ``timeDiscretizationWithEvents``
(``ocs2_sqp/ocs2_sqp/src/TimeDiscretization.cpp:36-114``): a uniform-dt grid
over [t0, tf] snapped to gait event times, with near-coincident points merged
(dt_min) and each event node duplicated into a pre/post pair so the
discontinuous mode change lands between two shooting nodes.

Static-shape note (SURVEY.md §7 "hard parts"): the solver needs *static*
node counts, so `discretize_fixed` produces exactly ``num_nodes`` nodes by
construction — the uniform grid absorbs events by *snapping* the nearest grid
point onto each event time (grid spacing stays within [0.5 dt, 1.5 dt]); the
pre/post duplication is represented by the per-interval contact flags, which
is what the discrete-time transcription actually consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Sequence

import numpy as np


class EventKind(Enum):
    NONE = 0
    PRE_EVENT = 1
    POST_EVENT = 2


@dataclass
class AnnotatedTime:
    """Reference AnnotatedTime (TimeDiscretization.h:39-52)."""

    time: float
    kind: EventKind = EventKind.NONE


def time_discretization_with_events(t0: float, tf: float, dt: float,
                                    event_times: Sequence[float],
                                    dt_min: float = 1e-5
                                    ) -> List[AnnotatedTime]:
    """Variable-length annotated grid (exact reference semantics)."""
    events = [t for t in sorted(event_times) if t0 + dt_min < t < tf - dt_min]
    grid: List[AnnotatedTime] = [AnnotatedTime(t0)]
    next_event = 0
    t = t0
    while t < tf - dt_min:
        t_next = min(t + dt, tf)
        if next_event < len(events) and events[next_event] <= t_next + dt_min:
            te = events[next_event]
            next_event += 1
            if te - t > dt_min:
                grid.append(AnnotatedTime(te, EventKind.PRE_EVENT))
            else:
                # merge: retag the previous node as the pre-event node
                grid[-1] = AnnotatedTime(te, EventKind.PRE_EVENT)
            grid.append(AnnotatedTime(te, EventKind.POST_EVENT))
            t = te
        else:
            grid.append(AnnotatedTime(t_next))
            t = t_next
    return grid


def discretize_fixed(t0: float, tf: float, num_nodes: int,
                     event_times: Sequence[float]) -> np.ndarray:
    """Fixed-size grid of ``num_nodes`` times with event snapping.

    Returns times (num_nodes,), strictly increasing, times[0] = t0,
    times[-1] = tf; for each event in (t0, tf) the nearest grid point is
    moved onto it so every mode change coincides with a shooting node.
    """
    assert num_nodes >= 2
    times = np.linspace(t0, tf, num_nodes)
    dt = times[1] - times[0]
    for te in sorted(event_times):
        if not (t0 + 1e-9 < te < tf - 1e-9):
            continue
        idx = int(np.clip(round((te - t0) / dt), 1, num_nodes - 2))
        times[idx] = te
    # Enforce monotonicity in pathological many-events-per-cell cases.
    for i in range(1, num_nodes):
        if times[i] <= times[i - 1]:
            times[i] = times[i - 1] + 1e-6
    return times


def interval_contact_flags(times: np.ndarray, mode_schedule) -> np.ndarray:
    """(num_nodes-1, 4) contact flags per shooting interval, sampled at
    interval midpoints (the discrete analogue of the pre/post event split)."""
    mids = 0.5 * (times[:-1] + times[1:])
    from cheeta_mpc.gait.motion_phase import contact_flags_of_mode
    modes = np.array([mode_schedule.mode_at(float(t)) for t in mids])
    return contact_flags_of_mode(modes)
