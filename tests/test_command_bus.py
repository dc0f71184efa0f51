"""Live-attach command CLIs: stdin -> shared-memory bus -> planner callbacks.

The reference's interactive command path (`GaitKeyboardPublisher.cpp:62-74`
keyboard -> `_mpc_mode_schedule`; `LeggedRobotPoseCommandNode.cpp:48-120`
pose -> `_mpc_target`) live against a running topology: the CLIs attach to
an existing shm bus with ``--bus`` and the planner-side MpcNode drains the
commands into its solver-synchronized callbacks.
"""

import io
import os

import numpy as np

from cheeta_mpc.cli import gait_command, pose_command
from cheeta_mpc.transport.mpc_mrt import TOPICS, MpcNode
from cheeta_mpc.transport.shm import ShmMessageBus
from cheeta_mpc.utils.info_config import load_gait_library

GAIT_INFO = "/root/reference/ocs2_legged_robot/config/command/gait.info"


def _bus_pair(name):
    creator = ShmMessageBus(TOPICS, name, create=True)
    return creator


def test_gait_command_stdin_to_planner():
    name = f"/cheeta_test_gait_{os.getpid()}"
    bus = _bus_pair(name)
    try:
        received = []
        node = MpcNode(bus, solve_fn=lambda obs: None,
                       on_gait_command=lambda n, t: received.append((n, t)))
        # The CLI attaches to the SAME segment by name (a separate mapping,
        # as a separate process would get) and publishes line-by-line.
        stdin = io.StringIO("bogus\ntrot\npace\n")
        out = io.StringIO()
        gait_command.run(GAIT_INFO, stdin=stdin, stdout=out, bus=name)
        node._poll_commands()  # the planner's solver-synchronized drain
        assert len(received) == 1  # drain-latest semantics
        got_name, got_template = received[0]
        assert got_name == "pace"
        lib = load_gait_library(GAIT_INFO)
        np.testing.assert_allclose(got_template.switching_times,
                                   lib["pace"].switching_times)
        assert got_template.mode_sequence == lib["pace"].mode_sequence
        assert "unknown gait 'bogus'" in out.getvalue()
    finally:
        bus.close()


def test_pose_command_stdin_to_planner():
    name = f"/cheeta_test_pose_{os.getpid()}"
    bus = _bus_pair(name)
    try:
        received = []
        node = MpcNode(bus, solve_fn=lambda obs: None,
                       on_target_command=lambda v: received.append(v))
        stdin = io.StringIO("1.0 0.0 0.0 0.0\n")
        out = io.StringIO()
        pose_command.run(stdin=stdin, stdout=out, bus=name)
        node._poll_commands()
        assert len(received) == 1
        v = np.ravel(received[0])
        # 1 m forward at the reference displacement velocity 0.5 m/s
        # -> t_arrival = 2 s -> vx = 0.5.
        np.testing.assert_allclose(v[:3], [0.5, 0.0, 0.0], atol=1e-9)
        assert "t+2.00s" in out.getvalue()
    finally:
        bus.close()
