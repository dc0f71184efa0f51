"""Cross-process shared-memory transport: the reference's two-node topology.

The reference deploys the planner and the tracker as separate ROS processes
(legged_robot_sqp.launch starting LeggedRobotSqpMpcNode +
LeggedRobotDummyNode; MPC_ROS_Interface.cpp:330-352,
MRT_ROS_Interface.cpp:246-281). Here the same MpcNode/MrtNode code runs over
the POSIX shared-memory seqlock bus (native/shm_bus.cpp) with the MPC side
in a REAL child process: observation out, policy in, blocking reset
handshake, torn-read integrity under hammer publishing.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from cheeta_mpc.transport.mpc_mrt import TOPICS, MrtNode
from cheeta_mpc.transport.shm import ShmMessageBus
from cheeta_mpc.mpc.runtime import SystemObservation


def _unique_name(tag):
    return f"/cheeta_test_{tag}_{os.getpid()}_{time.monotonic_ns() % 100000}"


def test_shm_roundtrip_same_process():
    name = _unique_name("rt")
    with ShmMessageBus(TOPICS, name, create=True, capacity=4096) as server:
        with ShmMessageBus(TOPICS, name) as client:
            assert server.seq("mpc_policy") == 0
            assert client.consume_latest("mpc_policy") == (0, None)
            s = server.publish("mpc_policy", b"hello")
            assert s == 1
            seq, payload = client.consume_latest("mpc_policy")
            assert (seq, payload) == (1, b"hello")
            # Latest-wins semantics (double buffer, no queue).
            server.publish("mpc_policy", b"world")
            seq, payload = client.consume_latest("mpc_policy")
            assert (seq, payload) == (2, b"world")
            # Blocking wait sees a publish from the other handle.
            t0 = time.monotonic()
            assert client.wait_for("mpc_reset_ack", 0, timeout_s=0.2) == 0
            assert time.monotonic() - t0 >= 0.15  # actually blocked
            server.publish("mpc_reset_ack", b"ok")
            assert client.wait_for("mpc_reset_ack", 0, timeout_s=1.0) == 1


_MPC_CHILD = r"""
import sys
import time

import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

from cheeta_mpc.mpc.runtime import PolicyData
from cheeta_mpc.transport.mpc_mrt import TOPICS, MpcNode
from cheeta_mpc.transport.shm import ShmMessageBus

name, ready_path = sys.argv[1], sys.argv[2]
bus = ShmMessageBus(TOPICS, name)


def solve(obs):
    # Deterministic fake planner: hold the observed state, u = -state[:2].
    n = obs.state.shape[0]
    N = 4
    times = obs.time + 0.01 * np.arange(N + 1)
    x = np.tile(obs.state, (N + 1, 1))
    u = np.tile(-obs.state[:2], (N, 1))
    return PolicyData(times=times, x_traj=x, u_traj=u, K=None)


node = MpcNode(bus, solve)
node.launch()
with open(ready_path, "w") as f:
    f.write("ready")
time.sleep(30.0)  # parent terminates us well before this
"""


def test_shm_two_process_mpc_mrt():
    name = _unique_name("2p")
    ready = tempfile.mktemp(prefix="cheeta_ready_")
    bus = ShmMessageBus(TOPICS, name, create=True)
    env = dict(os.environ, PYTHONPATH="/root/repo")
    child = subprocess.Popen(
        [sys.executable, "-c", _MPC_CHILD, name, ready], env=env)
    try:
        deadline = time.monotonic() + 30.0
        while not os.path.exists(ready):
            assert child.poll() is None, "MPC child process died"
            assert time.monotonic() < deadline, "MPC child never came up"
            time.sleep(0.02)

        mrt = MrtNode(bus)
        # Blocking reset handshake across the process boundary.
        assert mrt.reset_mpc(timeout_s=10.0)
        obs = SystemObservation(time=0.0, state=np.array([1.0, -2.0, 0.5]),
                                input=None, mode=0)
        assert mrt.wait_for_initial_policy(obs, timeout_s=10.0)
        u = mrt.evaluate_policy(0.0, obs.state)
        np.testing.assert_allclose(u, [-1.0, 2.0], atol=1e-6)

        # A few MPC ticks: fresh observation -> fresh policy from the child.
        for k in range(1, 6):
            obs = SystemObservation(time=0.01 * k,
                                    state=np.array([1.0 + k, 0.0, 0.0]),
                                    input=None, mode=0)
            mrt.set_current_observation(obs)
            seq = mrt._bus.wait_for("mpc_policy", mrt._last_policy_seq,
                                    timeout_s=5.0)
            assert seq > mrt._last_policy_seq, f"no policy for tick {k}"
            assert mrt.spin_once()
            assert mrt.update_policy()
            u = mrt.evaluate_policy(obs.time, obs.state)
            np.testing.assert_allclose(u, [-(1.0 + k), 0.0], atol=1e-5)
    finally:
        child.terminate()
        child.wait(timeout=10.0)
        bus.close()
        if os.path.exists(ready):
            os.unlink(ready)


_HAMMER_CHILD = r"""
import sys
import numpy as np
from cheeta_mpc.transport.shm import ShmMessageBus

name = sys.argv[1]
bus = ShmMessageBus(("t",), name)
payload_size = 65536
for i in range(20000):
    b = i % 251
    bus.publish("t", bytes([b]) * payload_size)
bus.publish("t", b"\xff" * payload_size)
"""


def test_shm_torn_read_stress():
    """Reader integrity under hammer publishing from another process: every
    consumed payload must be internally consistent (all bytes equal — a torn
    read would mix two patterns)."""
    name = _unique_name("torn")
    bus = ShmMessageBus(("t",), name, create=True, capacity=65536)
    env = dict(os.environ, PYTHONPATH="/root/repo")
    child = subprocess.Popen(
        [sys.executable, "-c", _HAMMER_CHILD, name], env=env)
    try:
        reads = 0
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            seq, payload = bus.consume_latest("t")
            if payload is not None:
                arr = np.frombuffer(payload, np.uint8)
                assert arr.size == 65536
                assert (arr == arr[0]).all(), (
                    f"torn read at seq {seq}: {np.unique(arr)}")
                reads += 1
                if arr[0] == 0xff:
                    break
            if child.poll() is not None and bus.seq("t") == 20001:
                seq, payload = bus.consume_latest("t")
                assert payload is not None
                break
        assert reads > 100, f"only {reads} reads completed"
        assert child.wait(timeout=30.0) == 0
    finally:
        if child.poll() is None:
            child.terminate()
            child.wait(timeout=10.0)
        bus.close()
