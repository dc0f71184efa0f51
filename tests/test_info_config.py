"""Config ingestion: the reference's shipped .info files load verbatim."""

import numpy as np
import pytest

from cheeta_mpc.utils.info_config import (as_list, as_matrix, load_info,
                                          load_gait_library, parse_info)

TASK_INFO = "/root/reference/ocs2_legged_robot/config/mpc/task.info"
GAIT_INFO = "/root/reference/ocs2_legged_robot/config/command/gait.info"
REFERENCE_INFO = "/root/reference/ocs2_legged_robot/config/command/reference.info"


def test_parse_basic():
    tree = parse_info("""
    a 1 ; comment
    b { c 2.5 // comment
        d true }
    """)
    assert tree == {"a": 1, "b": {"c": 2.5, "d": True}}


def test_task_info_loads():
    tree = load_info(TASK_INFO)
    assert tree["centroidalModelType"] == 1  # SRBD
    ms = tree["multiple_shooting"]
    assert ms["dt"] == 0.015
    assert ms["sqpIteration"] == 1
    assert ms["nThreads"] == 3
    assert tree["mpc"]["timeHorizon"] == 1.0
    assert tree["mpc"]["mpcDesiredFrequency"] == 50
    assert tree["mpc"]["mrtDesiredFrequency"] == 400
    x0 = as_matrix(tree["initialState"])
    assert x0.shape == (24,)
    assert x0[8] == 0.575  # base height
    Q = as_matrix(tree["Q"])
    assert Q.shape == (24, 24)
    assert tree["frictionConeSoftConstraint"]["frictionCoefficient"] == 0.5


def test_gait_library_loads():
    lib = load_gait_library(GAIT_INFO)
    expected = {"stance", "trot", "standing_trot", "flying_trot", "pace",
                "standing_pace", "dynamic_walk", "static_walk", "amble",
                "lindyhop", "skipping", "pawup"}
    assert expected <= set(lib)
    trot = lib["trot"]
    assert trot.mode_sequence == [9, 6]  # LF_RH, RF_LH
    assert trot.switching_times[0] == 0.0
    assert trot.duration == pytest.approx(0.7)
    stance = lib["stance"]
    assert stance.mode_sequence == [15]


def test_reference_info_loads():
    tree = load_info(REFERENCE_INFO)
    assert "comHeight" in tree
    assert tree["comHeight"] == pytest.approx(0.575)
    js = as_matrix(tree["defaultJointState"])
    assert js.shape == (12,)
