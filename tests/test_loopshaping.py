"""Loopshaping observation conversion (reference
LoopshapingSystemObservation.cpp:31-42 + LoopshapingDummyObserver)."""

import numpy as np

from cheeta_mpc.mpc.loopshaping import (LoopshapingDefinition,
                                        LoopshapingObserver,
                                        loopshaping_to_system_observation)
from cheeta_mpc.mpc.runtime import SystemObservation


def test_identity_loopshaping():
    d = LoopshapingDefinition(nx_sys=4)
    obs = SystemObservation(time=1.5, state=np.arange(4.0),
                            input=np.array([2.0, 3.0]), mode=9)
    out = loopshaping_to_system_observation(d, obs)
    np.testing.assert_array_equal(out.state, obs.state)
    np.testing.assert_array_equal(out.input, obs.input)
    assert out.time == obs.time and out.mode == obs.mode


def test_filter_strip_and_output_map():
    rng = np.random.default_rng(0)
    nx, nf, nu_sys, nu_aug = 3, 2, 2, 2
    C = rng.standard_normal((nu_sys, nf))
    D = rng.standard_normal((nu_sys, nu_aug))
    d = LoopshapingDefinition(nx_sys=nx, nf=nf, C_f=C, D_f=D)
    x_aug = rng.standard_normal(nx + nf)
    u_aug = rng.standard_normal(nu_aug)
    obs = SystemObservation(time=0.2, state=x_aug, input=u_aug, mode=3)
    out = loopshaping_to_system_observation(d, obs)
    np.testing.assert_array_equal(out.state, x_aug[:nx])
    np.testing.assert_allclose(out.input, D @ u_aug + C @ x_aug[nx:])
    # No input: stays None.
    out2 = loopshaping_to_system_observation(
        d, SystemObservation(time=0.2, state=x_aug))
    assert out2.input is None


def test_wrapped_observer_receives_system_coords():
    seen = []

    class Obs:
        def update(self, obs):
            seen.append(obs)

    d = LoopshapingDefinition(nx_sys=2, nf=1,
                              C_f=np.zeros((1, 1)), D_f=np.eye(1))
    w = LoopshapingObserver(d, [Obs()])
    w.update(SystemObservation(time=0.0, state=np.array([1.0, 2.0, 9.0]),
                               input=np.array([4.0])))
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].state, [1.0, 2.0])
    np.testing.assert_array_equal(seen[0].input, [4.0])
