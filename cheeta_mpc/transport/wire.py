"""Wire format: float32 serialization of observations and policies.

The reference ships policies over ROS as float32 arrays (flattened
controller, MPC_ROS_Interface.cpp:99-178 encode; MRT_ROS_Interface.cpp
readPolicyMsg:125-185 decode back to double). Same convention here: host
doubles are narrowed to float32 on the wire; numpy handles packing.

Layout (little-endian):
    observation: [time f64][mode u32][nx u32][state f32 x nx]
                 [nu u32][input f32 x nu]
    policy:      [t0 f64][N u32][nx u32][nu u32][has_K u8]
                 [times f64 x (N+1)][x f32 x (N+1)nx][u f32 x N nu]
                 [K f32 x N nu nx]?
    gait:        [name_len u16][name utf-8][M u32]
                 [switching_times f64 x (M+1)][modes i32 x M]
                 (reference ModeSequenceTemplate msg,
                 ModeSequenceTemplateRos.h / readModeSequenceTemplateMsg)
    target:      [n_rows u32][n_cols u32][f64 x rows*cols]
                 (reference TargetTrajectories msg: row 0 = times, the rest
                 = stacked desired-state columns; also used for plain
                 velocity-command vectors as a 1 x n row)
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from cheeta_mpc.gait.schedule import ModeSequenceTemplate
from cheeta_mpc.mpc.runtime import PolicyData, SystemObservation


def encode_observation(obs: SystemObservation) -> bytes:
    state = np.asarray(obs.state, np.float32)
    inp = (np.asarray(obs.input, np.float32) if obs.input is not None
           else np.zeros(0, np.float32))
    head = struct.pack("<dII", float(obs.time), int(obs.mode), state.size)
    return (head + state.tobytes() + struct.pack("<I", inp.size)
            + inp.tobytes())


def decode_observation(payload: bytes) -> SystemObservation:
    t, mode, nx = struct.unpack_from("<dII", payload, 0)
    off = struct.calcsize("<dII")
    state = np.frombuffer(payload, np.float32, nx, off).astype(np.float64)
    off += 4 * nx
    (nu,) = struct.unpack_from("<I", payload, off)
    off += 4
    inp = (np.frombuffer(payload, np.float32, nu, off).astype(np.float64)
           if nu else None)
    return SystemObservation(time=t, state=state, input=inp, mode=mode)


def encode_policy(policy: PolicyData) -> bytes:
    times = np.asarray(policy.times, np.float64)
    x = np.asarray(policy.x_traj, np.float32)
    u = np.asarray(policy.u_traj, np.float32)
    N, nu = u.shape
    nx = x.shape[1]
    has_k = policy.K is not None
    head = struct.pack("<dIIIB", float(times[0]), N, nx, nu, int(has_k))
    parts = [head, times.tobytes(), x.tobytes(), u.tobytes()]
    if has_k:
        parts.append(np.asarray(policy.K, np.float32).tobytes())
    return b"".join(parts)


def decode_policy(payload: bytes) -> PolicyData:
    t0, N, nx, nu, has_k = struct.unpack_from("<dIIIB", payload, 0)
    off = struct.calcsize("<dIIIB")
    times = np.frombuffer(payload, np.float64, N + 1, off)
    off += 8 * (N + 1)
    x = np.frombuffer(payload, np.float32, (N + 1) * nx,
                      off).astype(np.float64).reshape(N + 1, nx)
    off += 4 * (N + 1) * nx
    u = np.frombuffer(payload, np.float32, N * nu,
                      off).astype(np.float64).reshape(N, nu)
    off += 4 * N * nu
    K: Optional[np.ndarray] = None
    if has_k:
        K = np.frombuffer(payload, np.float32, N * nu * nx,
                          off).astype(np.float64).reshape(N, nu, nx)
    return PolicyData(times=times.copy(), x_traj=x, u_traj=u, K=K)


def encode_gait_command(name: str,
                        template: ModeSequenceTemplate) -> bytes:
    """Gait command wire format (the reference publishes
    ModeSequenceTemplate on `_mpc_mode_schedule`,
    GaitKeyboardPublisher.cpp:62-74 / ModeSequenceTemplateRos.h)."""
    nm = name.encode("utf-8")
    st = np.asarray(template.switching_times, np.float64)
    modes = np.asarray(template.mode_sequence, np.int32)
    return (struct.pack("<H", len(nm)) + nm
            + struct.pack("<I", modes.size)
            + st.tobytes() + modes.tobytes())


def decode_gait_command(payload: bytes) -> Tuple[str, ModeSequenceTemplate]:
    (nlen,) = struct.unpack_from("<H", payload, 0)
    off = 2
    name = payload[off:off + nlen].decode("utf-8")
    off += nlen
    (m,) = struct.unpack_from("<I", payload, off)
    off += 4
    st = np.frombuffer(payload, np.float64, m + 1, off)
    off += 8 * (m + 1)
    modes = np.frombuffer(payload, np.int32, m, off)
    return name, ModeSequenceTemplate(switching_times=list(st),
                                      mode_sequence=[int(v) for v in modes])


def encode_target_command(target: np.ndarray) -> bytes:
    """Target-trajectory / command wire format (the reference publishes
    TargetTrajectories on `_mpc_target`,
    TargetTrajectoriesRosPublisher.cpp:40-60). `target` is any 1-D or 2-D
    f64 array — a velocity command vector or a [times; states] matrix."""
    arr = np.atleast_2d(np.asarray(target, np.float64))
    return struct.pack("<II", arr.shape[0], arr.shape[1]) + arr.tobytes()


def decode_target_command(payload: bytes) -> np.ndarray:
    rows, cols = struct.unpack_from("<II", payload, 0)
    arr = np.frombuffer(payload, np.float64, rows * cols, 8)
    arr = arr.reshape(rows, cols).copy()
    return arr[0] if rows == 1 else arr
