"""Multi-process launch topology (cli/launch.py) + command topics.

The reference's deployment is a roslaunch graph of separate processes
(`legged_robot_sqp.launch`: sqp_mpc node + dummy node + target + gait
command terminals). These tests drive the same topology end-to-end: the
launcher spawns a REAL planning process and a REAL plant process over the
shared-memory bus, a live gait command crosses the process boundary
mid-run (GaitKeyboardPublisher -> `_mpc_mode_schedule` -> GaitReceiver
preSolverRun), and the closed loop keeps walking through the transition.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from cheeta_mpc.gait.schedule import ModeSequenceTemplate
from cheeta_mpc.mpc.runtime import PolicyData, SystemObservation
from cheeta_mpc.transport.mpc_mrt import (TOPICS, CommandClient, MpcNode,
                                          MrtNode, make_bus)
from cheeta_mpc.transport.wire import (decode_gait_command,
                                       decode_target_command,
                                       encode_gait_command,
                                       encode_target_command)

REPO = str(Path(__file__).resolve().parents[1])


def test_command_wire_roundtrip():
    tpl = ModeSequenceTemplate(switching_times=[0.0, 0.3, 0.6],
                               mode_sequence=[9, 6])
    name, out = decode_gait_command(encode_gait_command("trot", tpl))
    assert name == "trot"
    assert out.switching_times == tpl.switching_times
    assert out.mode_sequence == tpl.mode_sequence

    v = np.array([0.25, 0.0, 0.1])
    np.testing.assert_array_equal(decode_target_command(
        encode_target_command(v)), v)
    # 2-D target trajectory matrix survives too.
    m = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(decode_target_command(
        encode_target_command(m)), m)


def test_mpc_node_applies_commands_before_solve():
    """A command published before an observation must be visible to that
    observation's solve (lock-step determinism — the reference's
    solver-synchronized GaitReceiver contract)."""
    bus = make_bus()
    log = []

    def solve(obs):
        log.append(("solve", obs.time))
        return PolicyData(times=obs.time + 0.01 * np.arange(3),
                          x_traj=np.zeros((3, 2)), u_traj=np.zeros((2, 1)),
                          K=None)

    node = MpcNode(bus, solve,
                   on_gait_command=lambda nm, t: log.append(("gait", nm)),
                   on_target_command=lambda v: log.append(
                       ("target", tuple(v))))
    node.launch()
    try:
        mrt = MrtNode(bus)
        cmd = CommandClient(bus)
        tpl = ModeSequenceTemplate(switching_times=[0.0, 0.3, 0.6],
                                   mode_sequence=[9, 6])
        for k in range(3):
            cmd.publish_gait("trot", tpl)
            cmd.publish_target(np.array([0.1 * (k + 1), 0.0, 0.0]))
            obs = SystemObservation(time=0.01 * k, state=np.zeros(2),
                                    input=None, mode=0)
            mrt.set_current_observation(obs)
            seq = bus.wait_for("mpc_policy", k, timeout_s=5.0)
            assert seq == k + 1
        # Every solve is preceded (somewhere earlier in the log) by that
        # tick's gait+target commands.
        for k in range(3):
            i = log.index(("solve", 0.01 * k))
            before = log[:i]
            assert ("gait", "trot") in before
            assert ("target", (0.1 * (k + 1), 0.0, 0.0)) in before
    finally:
        node.shutdown()


def test_two_process_launch_with_live_gait_switch(tmp_path):
    """Full launch topology: planner and plant as separate OS processes over
    shared memory; a trot command is published live mid-run; the robot
    walks through the gait transition and stays upright."""
    out = str(tmp_path / "launch")
    from cheeta_mpc.utils.compile_cache import compile_cache_dir
    from tests.conftest import _cpu_key
    env = dict(os.environ, PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=compile_cache_dir(f"cpu_{_cpu_key}"))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "cheeta_mpc.cli.launch",
         "--platform", "cpu", "--seconds", "0.9", "--vx", "0.25",
         "--gait", "trot", "--horizon", "10", "--switch-gait",
         "standing_trot@0.4", "--out", out],
        env=env, capture_output=True, text=True, timeout=900)
    wall = time.monotonic() - t0
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    with open(out + "_summary.json") as f:
        summary = json.load(f)
    assert summary["finite"]
    assert summary["solves"] >= 25  # handshake + ~30 MPC ticks
    assert summary["forward_m"] > 0.05  # walked forward at 0.25 m/s cmd
    assert summary["height_drift_m"] < 0.08
    assert summary["switched_at"] is not None  # live command was applied
    traj = np.load(out + "_traj.npz")
    assert np.isfinite(traj["states"]).all()
    print(f"launch topology ok in {wall:.1f}s: {summary}")
