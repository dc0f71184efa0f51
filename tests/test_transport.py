"""Native bus, wire codec, and the threaded MPC/MRT split."""

import threading
import time

import numpy as np
import pytest

from cheeta_mpc.mpc.runtime import PolicyData, SystemObservation
from cheeta_mpc.transport.bus import MessageBus
from cheeta_mpc.transport.mpc_mrt import MpcNode, MrtNode, make_bus
from cheeta_mpc.transport.wire import (decode_observation, decode_policy,
                                       encode_observation, encode_policy)


def test_native_bus_builds():
    bus = MessageBus(["a"], native=True)
    assert bus.is_native, "native C++ bus failed to build/load"
    bus.close()


@pytest.mark.parametrize("native", [True, False])
def test_bus_publish_consume(native):
    bus = MessageBus(["a", "b"], native=native)
    seq, payload = bus.consume_latest("a")
    assert seq == 0 and payload is None
    s1 = bus.publish("a", b"hello")
    s2 = bus.publish("a", b"world!")
    assert s2 == s1 + 1
    seq, payload = bus.consume_latest("a")
    assert seq == s2 and payload == b"world!"  # latest-wins semantics
    assert bus.consume_latest("b") == (0, None)  # topics are independent
    bus.close()


@pytest.mark.parametrize("native", [True, False])
def test_bus_wait(native):
    bus = MessageBus(["t"], native=native)

    def later():
        time.sleep(0.05)
        bus.publish("t", b"x")

    threading.Thread(target=later).start()
    t0 = time.monotonic()
    seq = bus.wait_for("t", 0, timeout_s=2.0)
    assert seq == 1
    assert time.monotonic() - t0 < 1.0
    # timeout path
    assert bus.wait_for("t", 5, timeout_s=0.05) <= 5
    bus.close()


def test_native_bus_stress_torn_reads():
    """Concurrent publisher + reader: every read is a consistent message."""
    bus = MessageBus(["t"], native=True)
    n_msgs = 2000
    payloads = [bytes([i % 256]) * 256 for i in range(n_msgs)]

    def writer():
        for p in payloads:
            bus.publish("t", p)

    bad = []

    def reader():
        for _ in range(4000):
            seq, payload = bus.consume_latest("t")
            if payload is not None and len(set(payload)) != 1:
                bad.append(payload)

    wt = threading.Thread(target=writer)
    rt = threading.Thread(target=reader)
    rt.start(); wt.start(); wt.join(); rt.join()
    assert not bad, f"torn reads detected: {len(bad)}"
    assert bus.seq("t") == n_msgs
    bus.close()


def test_wire_roundtrip_observation():
    obs = SystemObservation(time=1.25, state=np.arange(24.0), mode=9,
                            input=np.arange(24.0) * 0.5)
    out = decode_observation(encode_observation(obs))
    assert out.time == 1.25 and out.mode == 9
    np.testing.assert_allclose(out.state, obs.state, atol=1e-5)
    np.testing.assert_allclose(out.input, obs.input, atol=1e-5)


def test_wire_roundtrip_policy():
    rng = np.random.default_rng(0)
    pol = PolicyData(times=np.arange(11.0) * 0.015,
                     x_traj=rng.normal(size=(11, 24)),
                     u_traj=rng.normal(size=(10, 24)),
                     K=rng.normal(size=(10, 24, 24)))
    out = decode_policy(encode_policy(pol))
    np.testing.assert_allclose(out.times, pol.times, atol=0)  # f64 on wire
    np.testing.assert_allclose(out.x_traj, pol.x_traj, atol=1e-5)  # f32 wire
    np.testing.assert_allclose(out.u_traj, pol.u_traj, atol=1e-5)
    np.testing.assert_allclose(out.K, pol.K, atol=1e-5)
    pol2 = PolicyData(times=pol.times, x_traj=pol.x_traj, u_traj=pol.u_traj)
    assert decode_policy(encode_policy(pol2)).K is None


def test_reset_immediately_after_launch():
    """Regression: a reset published right after launch() (before the spin
    thread's first poll) must still be acked. Root cause of round-1 flake:
    MpcNode snapshotted the reset baseline inside the spin thread, absorbing
    early requests. 100 reps to make the lost-wakeup window statistically
    visible."""
    def solve_fn(obs):
        return PolicyData(times=obs.time + 0.1 * np.arange(2),
                          x_traj=np.zeros((2, 2)), u_traj=np.zeros((1, 1)))

    for _ in range(100):
        bus = make_bus(native=True)
        mpc = MpcNode(bus, solve_fn)
        mrt = MrtNode(bus)
        mpc.launch()
        try:
            assert mrt.reset_mpc(timeout_s=5.0)
        finally:
            mpc.shutdown()
            bus.close()


def test_threaded_mpc_mrt_split():
    """Full split: MRT handshake -> MPC solves in its own thread -> MRT
    consumes policies; toy double-integrator regulated closed-loop."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.0], [0.1]])
    K = np.array([[-0.8, -1.2]])

    def solve_fn(obs):
        xs, us = [np.asarray(obs.state)], []
        for _ in range(10):
            u = K @ xs[-1]
            us.append(u)
            xs.append(A @ xs[-1] + B @ u)
        return PolicyData(times=obs.time + 0.1 * np.arange(11),
                          x_traj=np.stack(xs), u_traj=np.stack(us),
                          K=np.tile(K[None], (10, 1, 1)))

    bus = make_bus(native=True)
    mpc = MpcNode(bus, solve_fn)
    mrt = MrtNode(bus)
    mpc.launch()
    try:
        assert mrt.reset_mpc(timeout_s=5.0)
        x = np.array([1.0, 0.0])
        t = 0.0
        assert mrt.wait_for_initial_policy(
            SystemObservation(time=t, state=x), timeout_s=10.0)
        for step in range(80):
            u = mrt.evaluate_policy(t, x)
            x = A @ x + B @ u
            t += 0.1
            mrt.set_current_observation(SystemObservation(time=t, state=x))
            # Give the planner a chance, then drain at most one policy.
            bus.wait_for("mpc_policy", mrt._last_policy_seq, timeout_s=0.2)
            if mrt.spin_once():
                mrt.update_policy()
        assert np.linalg.norm(x) < 0.05, f"not regulated: {x}"
        assert mpc.solve_count > 10
    finally:
        mpc.shutdown()
        bus.close()
