"""CLI application nodes (gait command, pose command)."""

import io

import numpy as np

from cheeta_mpc.cli.gait_command import run as gait_run
from cheeta_mpc.cli.pose_command import command_to_target, run as pose_run


def test_gait_command_node():
    commands = []
    out = io.StringIO()
    gait_run(stdin=io.StringIO("trot\nbogus\nflying_trot\n"),
             stdout=out,
             on_command=lambda name, tmpl: commands.append((name, tmpl)))
    assert [c[0] for c in commands] == ["trot", "flying_trot"]
    assert commands[0][1].duration > 0
    assert "unknown gait 'bogus'" in out.getvalue()


def test_pose_command_conversion():
    times, poses = command_to_target(np.zeros(4), 1.0, 0.0, 0.0, 0.0)
    # 1 m at 0.5 m/s -> 2 s arrival (reference velocity-based arrival).
    np.testing.assert_allclose(times, [0.0, 2.0])
    np.testing.assert_allclose(poses[1], [1.0, 0, 0, 0])
    times, poses = command_to_target(np.zeros(4), 0.0, 0.0, 0.0, 90.0)
    np.testing.assert_allclose(times[1], (np.pi / 2) / 1.57, rtol=1e-3)


def test_pose_command_node():
    out = io.StringIO()
    pose_run(stdin=io.StringIO("1 0 0 0\nnot numbers\n0 1 0 90\n"),
             stdout=out)
    text = out.getvalue()
    assert "x=1.00" in text
    assert "expected 4 numbers" in text
    assert "yaw=90.0deg" in text
