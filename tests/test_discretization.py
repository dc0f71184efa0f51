"""Time discretization with gait events (reference testDiscretization.cpp
analogue)."""

import numpy as np

from cheeta_mpc.gait.schedule import ModeSchedule
from cheeta_mpc.solvers.discretization import (
    EventKind, discretize_fixed, interval_contact_flags,
    time_discretization_with_events)


def test_no_events_uniform():
    grid = time_discretization_with_events(0.0, 1.0, 0.1, [])
    times = [a.time for a in grid]
    np.testing.assert_allclose(times, np.arange(11) * 0.1, atol=1e-12)
    assert all(a.kind == EventKind.NONE for a in grid)


def test_event_duplication():
    grid = time_discretization_with_events(0.0, 1.0, 0.1, [0.35])
    times = [a.time for a in grid]
    kinds = [a.kind for a in grid]
    # The event appears exactly twice: pre then post.
    idx = times.index(0.35)
    assert kinds[idx] == EventKind.PRE_EVENT
    assert times[idx + 1] == 0.35
    assert kinds[idx + 1] == EventKind.POST_EVENT
    assert times == sorted(times)


def test_event_merges_with_close_grid_point():
    grid = time_discretization_with_events(0.0, 1.0, 0.1, [0.300000001])
    times = [a.time for a in grid]
    # 0.3 grid point retagged, not duplicated-with-tiny-interval.
    assert sum(1 for t in times if abs(t - 0.3) < 1e-6) == 2  # pre + post
    diffs = np.diff(times)
    assert (diffs[diffs > 0] > 1e-5).all()


def test_fixed_grid_snaps_events():
    times = discretize_fixed(0.0, 1.0, 11, [0.33, 0.74])
    assert len(times) == 11
    assert times[0] == 0.0 and times[-1] == 1.0
    assert np.any(np.abs(times - 0.33) < 1e-12)
    assert np.any(np.abs(times - 0.74) < 1e-12)
    assert (np.diff(times) > 0).all()


def test_interval_flags_respect_events():
    times = discretize_fixed(0.0, 1.0, 11, [0.5])
    ms = ModeSchedule(event_times=[0.5], mode_sequence=[15, 9])
    flags = interval_contact_flags(times, ms)
    assert flags.shape == (10, 4)
    k_event = int(np.argmin(np.abs(times - 0.5)))
    np.testing.assert_allclose(flags[k_event - 1], [1, 1, 1, 1])  # STANCE
    np.testing.assert_allclose(flags[k_event], [1, 0, 0, 1])  # LF_RH
