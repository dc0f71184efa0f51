"""Smoke run of the centroidal MPC on an NVIDIA GPU, through the public API.

    python chip_smoke.py             # phases 0-5 on one GPU
    python chip_smoke.py --cards 4   # only: fleet sharded over 4 GPUs vs 1

Runs the reference's north-star solve at its full published width (horizon
N=10, augmented state nx=33, input nu=24, ng=32 inequality rows) in f32 on
the first GPU:

0. device: the first JAX device must be a GPU (anything else exits non-zero
   before any result is printed); prints the card's name and power limit;
1. batch-1 cold solve (2 SQP x 10 IPM) through ``CentroidalMPC``, compared
   with the same solve in f64 on the host CPU backend;
2. warm real-time-iteration tick (1 SQP x 6 IPM) from the shifted previous
   solution;
3. the 20-tick on-device MPC loop (``build_centroidal_mpc_loop``);
4. a fleet of 1024 solves through ``parallel.mesh.sharded_batch_solver``;
5. the phase-1 solve at ``matmul_precision='default'`` (TF32 on the card),
   reported against ``'highest'``.

Every phase prints one line naming the card; the last line is one JSON
object. A failed check raises ``SystemExit`` with a non-zero code. The phase
functions take their sizes as arguments so the test suite runs them small on
the CPU (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from cheeta_mpc.examples import TEST_WEIGHTS, make_example_inputs
from cheeta_mpc.models.centroidal import GRAVITY
from cheeta_mpc.mpc.centroidal_mpc import (CentroidalMPC,
                                           build_centroidal_mpc_loop,
                                           build_centroidal_solver)
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.parallel.mesh import (aggregate_fleet_health, make_mesh,
                                      shard_batch, sharded_batch_solver)
from cheeta_mpc.solvers.scp import ScpSettings
from cheeta_mpc.utils.compile_cache import enable_compile_cache

MASS = 8.0
NUM_LEGS = 4
HORIZON = 10
DT = 0.01
MU = 0.8
MG = MASS * GRAVITY  # 78.48 N
COLD = ScpSettings(iterations=2, ipm=IpmSettings(iters=10))
WARM = ScpSettings(iterations=1, ipm=IpmSettings(iters=6))
NON_RTI = ScpSettings(iterations=4, ipm=IpmSettings(iters=10))
HERE = Path(__file__).resolve().parent
# The golden-GRF criterion (tests/test_golden_grf.py): f32 at 'highest'
# precision against the f64 solve, and any executor against any other.
GRF_TOL = 1e-3


def check(cond, msg: str) -> None:
    """Stop the run with a non-zero exit when ``cond`` is false."""
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def _mpc(horizon: int, dtype, scp: ScpSettings) -> CentroidalMPC:
    return CentroidalMPC(MASS, NUM_LEGS, horizon, DT, TEST_WEIGHTS,
                         [MU] * NUM_LEGS, dtype=dtype, scp=scp).setup_mpc()


def _f32(arrays):
    return tuple(jnp.asarray(a, jnp.float32) for a in arrays)


def _stance_inputs(des_inputs: np.ndarray, horizon: int) -> np.ndarray:
    """``des_inputs`` with every leg in contact on every node (a hold)."""
    out = np.array(des_inputs, copy=True)
    stride = 4 * horizon + 3
    for leg in range(NUM_LEGS):
        out[..., leg * stride:leg * stride + horizon] = 1.0
    return out


def _enable_table(des_inputs: np.ndarray, horizon: int) -> np.ndarray:
    """(..., num_legs, horizon) contact flags from the packed inputs."""
    stride = 4 * horizon + 3
    return np.stack([np.asarray(des_inputs)[..., leg * stride:
                                            leg * stride + horizon]
                     for leg in range(NUM_LEGS)], axis=-2) > 0.5


def _check_forces(grf: np.ndarray, des_inputs: np.ndarray, horizon: int,
                  fz_band: float, what: str) -> float:
    """Finite, exact swing zeros, per-step total Fz within ``fz_band`` of
    m*g. ``grf`` is (..., num_legs, 3, N). Returns the worst relative Fz
    deviation."""
    check(np.isfinite(grf).all(), f"{what}: non-finite forces")
    stance = _enable_table(des_inputs, horizon)[..., :, None, :]
    swing = np.abs(np.where(stance, 0.0, grf)).max()
    check(swing == 0.0, f"{what}: swing-leg force {swing} N (must be 0)")
    fz_dev = float(np.abs(grf[..., 2, :].sum(axis=-2) - MG).max() / MG)
    check(fz_dev <= fz_band,
          f"{what}: total Fz off m*g by {100 * fz_dev:.1f} % "
          f"(limit {100 * fz_band:.0f} %)")
    return fz_dev


def _percentiles_ms(fn, reps: int):
    """p50/p99 wall milliseconds of ``fn()``, each call ended by
    ``block_until_ready``; returns (p50, p99, last result)."""
    lat, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        lat.append((time.perf_counter() - t0) * 1e3)
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)),
            out)


def _timed_first_call(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return time.perf_counter() - t0, out


def _line(card: str, phase: str, **fields) -> None:
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{card}] {phase}: {kv}", flush=True)


def reference_grf(horizon: int = HORIZON) -> np.ndarray:
    """The phase-1 solve in f64 on the CPU backend (the repo's plain
    reference, as in tests/test_golden_grf.py): (num_legs, 3, N) forces.

    Runs in a child process that never opens the GPU, with the persistent
    compile cache off: XLA:CPU executables are specific to the host CPU, and
    a cache shared between machines could hand this solve a foreign one."""
    code = ("import sys, numpy as np, chip_smoke; np.save(sys.stdout.buffer, "
            f"chip_smoke._reference_grf_in_process({horizon}))")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               JAX_ENABLE_COMPILATION_CACHE="false",
               CHEETA_STAGE_UNROLL="1")  # same numbers, faster CPU compile
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                          capture_output=True, timeout=900)
    check(proc.returncode == 0, "f64 CPU reference solve failed:\n"
          + proc.stderr.decode(errors="replace")[-2000:])
    return np.load(io.BytesIO(proc.stdout))


def _reference_grf_in_process(horizon: int) -> np.ndarray:
    mpc = _mpc(horizon, jnp.float64, COLD)
    args = tuple(jnp.asarray(a, jnp.float64)
                 for a in make_example_inputs(mpc.config))
    return np.asarray(mpc.update_mpc(*args).contact_force)


def phase_device() -> jax.Device:
    """Phase 0: the first JAX device must be a GPU; then the persistent
    compile cache is enabled and the card is described."""
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"no GPU: the first JAX device is {dev.platform} ({dev})")
    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for row in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {row.strip()}", flush=True)
    _line(dev.device_kind, "phase 0 device", platform=dev.platform,
          count=len(jax.devices()), jax=jax.__version__,
          XLA_FLAGS=repr(os.environ.get("XLA_FLAGS", "")),
          compile_cache=cache)
    return dev


def phase_cold(card: str, ref_grf: np.ndarray, horizon: int = HORIZON,
               reps: int = 50) -> dict:
    """Phase 1: batch-1 cold solve (README quick start) vs the f64 CPU
    solve ``ref_grf``."""
    mpc = _mpc(horizon, jnp.float32, COLD)
    raw = make_example_inputs(mpc.config)
    args = _f32(raw)
    compile_s, sol = _timed_first_call(lambda: mpc.update_mpc(*args))
    grf = np.asarray(sol.contact_force)
    check(grf.shape == (NUM_LEGS, 3, horizon), f"cold: shape {grf.shape}")
    # The scenario's CoM reference rises and switches diagonal pairs, so the
    # optimum itself leaves m*g by ~1/3 at the switch (f64 included); 50 %
    # flags a solve that drops the robot.
    fz_dev = _check_forces(grf, raw[2], horizon, 0.5, "cold")
    err = float(np.abs(grf - ref_grf).max())
    check(err <= GRF_TOL, f"cold: |dGRF| vs f64 CPU = {err} N > {GRF_TOL}")
    p50, p99, _ = _percentiles_ms(lambda: mpc.update_mpc(*args), reps)
    _line(card, "phase 1 batch-1 cold (2 SQP x 10 IPM)",
          compile_s=f"{compile_s:.3f}", p50_ms=f"{p50:.4f}",
          p99_ms=f"{p99:.4f}", max_dgrf_vs_f64_cpu_N=f"{err:.3e}",
          max_fz_dev_pct=f"{100 * fz_dev:.2f}")
    return {"grf": grf, "sol": sol, "args": args, "compile_s": compile_s,
            "p50_ms": p50, "p99_ms": p99, "err_vs_f64_N": err}


def phase_warm(card: str, cold: dict, horizon: int = HORIZON,
               reps: int = 50) -> dict:
    """Phase 2: the warm real-time-iteration tick, warm-started from the
    previous solution shifted one node (MultipleShootingSolver.cpp:229-265
    in the reference)."""
    mpc = _mpc(horizon, jnp.float32, WARM)
    solve_warm = build_centroidal_solver(mpc.config, WARM)

    @jax.jit
    def tick(state, des_state, des_inputs, x_prev, u_prev):
        x_w = jnp.concatenate([x_prev[1:], x_prev[-1:]])
        u_w = jnp.concatenate([u_prev[1:], u_prev[-1:]])
        sol = solve_warm(state, des_state, des_inputs, warm=(x_w, u_w))
        return sol.x_traj, sol.u_traj, sol.contact_force

    args = cold["args"]
    carry = [cold["sol"].x_traj, cold["sol"].u_traj]

    def step():
        x, u, f = tick(*args, *carry)
        carry[:] = [x, u]
        return f

    compile_s, _ = _timed_first_call(step)
    p50, p99, _ = _percentiles_ms(step, reps)
    x, u = (np.asarray(a) for a in carry)
    check(np.isfinite(x).all() and np.isfinite(u).all(),
          "warm: non-finite iterate")
    grf = np.asarray(tick(*args, *carry)[2])
    _check_forces(grf, np.asarray(args[2]), horizon, 0.5, "warm")
    _line(card, "phase 2 warm RTI tick (1 SQP x 6 IPM)",
          compile_s=f"{compile_s:.3f}", p50_ms=f"{p50:.4f}",
          p99_ms=f"{p99:.4f}", ticks=reps)
    return {"p50_ms": p50, "p99_ms": p99}


def phase_loop(card: str, horizon: int = HORIZON, n_ticks: int = 20,
               reps: int = 20) -> dict:
    """Phase 3: the on-device receding-horizon loop on an all-stance hold;
    total Fz within 10 % of m*g on every tick."""
    cfg = _mpc(horizon, jnp.float32, WARM).config
    loop = jax.jit(build_centroidal_mpc_loop(cfg, WARM, n_ticks=n_ticks))
    state, des_state, des_inputs = make_example_inputs(cfg)
    args = _f32((state, des_state, _stance_inputs(des_inputs, horizon)))
    compile_s, (xs, fs) = _timed_first_call(lambda: loop(*args))
    p50, p99, (xs, fs) = _percentiles_ms(lambda: loop(*args), reps)
    fs = np.asarray(fs)
    check(fs.shape == (n_ticks, NUM_LEGS, 3), f"loop: shape {fs.shape}")
    check(np.isfinite(fs).all() and np.isfinite(np.asarray(xs)).all(),
          "loop: non-finite")
    fz_dev = float(np.abs(fs[:, :, 2].sum(axis=1) - MG).max() / MG)
    check(fz_dev <= 0.1, f"loop: total Fz off m*g by {100 * fz_dev:.1f} %")
    rate = n_ticks / (p50 / 1e3)
    _line(card, f"phase 3 on-device loop ({n_ticks} ticks)",
          compile_s=f"{compile_s:.3f}", p50_ms=f"{p50:.4f}",
          p99_ms=f"{p99:.4f}", replans_per_s=f"{rate:.1f}",
          max_fz_dev_pct=f"{100 * fz_dev:.2f}")
    return {"replans_per_s": rate, "p50_ms": p50}


def _fleet_args(cfg, batch: int):
    """``batch`` scenarios; element 0 is the phase-1 scenario."""
    state, des_state, des_inputs = make_example_inputs(cfg, batch=batch)
    for a, one in zip((state, des_state, des_inputs),
                      make_example_inputs(cfg)):
        a[0] = one
    return state, des_state, des_inputs


def _fleet_solve(cfg, scp: ScpSettings, mesh, raw):
    solve = sharded_batch_solver(build_centroidal_solver(cfg, scp), mesh)
    args = shard_batch(mesh, _f32(raw))
    return solve, args


def phase_fleet(card: str, cold: dict, horizon: int = HORIZON,
                batch: int = 1024, reps: int = 10) -> dict:
    """Phase 4: a fleet batch through ``sharded_batch_solver`` on a
    1-device mesh; element 0 must match the phase-1 solve."""
    cfg = _mpc(horizon, jnp.float32, COLD).config
    raw = _fleet_args(cfg, batch)
    solve, args = _fleet_solve(cfg, COLD, make_mesh(1), raw)
    compile_s, sol = _timed_first_call(lambda: solve(*args))
    grf = np.asarray(sol.contact_force)
    check(grf.shape == (batch, NUM_LEGS, 3, horizon),
          f"fleet: shape {grf.shape}")
    _check_forces(grf, raw[2], horizon, 0.5, "fleet")
    err = float(np.abs(grf[0] - cold["grf"]).max())
    check(err <= GRF_TOL, f"fleet element 0 vs batch-1: {err} N")
    p50, p99, _ = _percentiles_ms(lambda: solve(*args), reps)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not reported")
    rate = batch / (p50 / 1e3)
    _line(card, f"phase 4 fleet (batch {batch}, 2 SQP x 10 IPM)",
          compile_s=f"{compile_s:.3f}", p50_ms=f"{p50:.4f}",
          p99_ms=f"{p99:.4f}", solves_per_s=f"{rate:.1f}",
          peak_bytes_in_use=peak,
          max_dgrf_elem0_vs_batch1_N=f"{err:.3e}")
    return {"grf": grf, "batch": batch, "solves_per_s": rate,
            "err_vs_batch1_N": err}


def phase_precision(card: str, cold: dict, horizon: int = HORIZON) -> dict:
    """Phase 5: the phase-1 solve at matmul_precision='default' (TF32 on an
    NVIDIA GPU); reports its distance from 'highest'."""
    mpc = _mpc(horizon, jnp.float32,
               COLD._replace(matmul_precision="default"))
    grf = np.asarray(mpc.update_mpc(*cold["args"]).contact_force)
    check(np.isfinite(grf).all(), "precision: non-finite forces")
    err = float(np.abs(grf - cold["grf"]).max())
    _line(card, "phase 5 precision 'default' vs 'highest'",
          max_dgrf_N=f"{err:.3e}")
    return {"err_default_vs_highest_N": err}


def phase_cards(card: str, n_cards: int = 4, horizon: int = HORIZON,
                batch: int = 1024) -> dict:
    """``--cards N``: the fleet sharded over an N-device mesh against the
    same batch on one device, plus the mesh-wide fleet-health reduction of
    a non-RTI (4 SQP) fleet."""
    check(len(jax.devices()) >= n_cards,
          f"--cards {n_cards}: only {len(jax.devices())} devices")
    cfg = _mpc(horizon, jnp.float32, COLD).config
    raw = _fleet_args(cfg, batch)
    mesh_n = make_mesh(n_cards)
    grf = {}
    for n, mesh in ((n_cards, mesh_n), (1, make_mesh(1))):
        solve, args = _fleet_solve(cfg, COLD, mesh, raw)
        grf[n] = np.asarray(solve(*args).contact_force)
        check(np.isfinite(grf[n]).all(), f"{n}-device fleet: non-finite")
    err = float(np.abs(grf[n_cards] - grf[1]).max())
    check(err <= GRF_TOL,
          f"{n_cards}-device vs 1-device fleet: {err} N > {GRF_TOL}")
    solve, args = _fleet_solve(cfg, NON_RTI, mesh_n, raw)
    sol = solve(*args)
    health = aggregate_fleet_health(mesh_n, sol.qp_mu, sol.convergence,
                                    sol.merit)
    n_solves, n_bad, n_conv = (int(health.n_solves),
                               int(health.n_nonfinite),
                               int(health.n_converged))
    check(n_solves == batch, f"fleet health counted {n_solves} != {batch}")
    check(n_bad == 0, f"fleet health: {n_bad} non-finite solves")
    check(n_conv > 0, "fleet health: no converged solve in 4-SQP mode")
    _line(card, f"cards {n_cards}: fleet batch {batch} sharded",
          max_dgrf_vs_1_device_N=f"{err:.3e}", n_solves=n_solves,
          n_nonfinite=n_bad, n_converged=n_conv,
          merit_mean=f"{float(health.merit_mean):.3f}")
    return {"err_vs_1_device_N": err, "n_converged": n_conv}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1: run only the fleet sharded over N "
                         "GPUs against one GPU")
    args = ap.parse_args(argv)
    dev = phase_device()
    card = dev.device_kind
    if args.cards > 1:
        phase_cards(card, args.cards)
    else:
        cold = phase_cold(card, reference_grf())
        phase_warm(card, cold)
        phase_loop(card)
        phase_fleet(card, cold)
        phase_precision(card, cold)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
