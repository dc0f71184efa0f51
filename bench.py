"""Centroidal-MPC timings on one GPU, as one JSON line.

    python bench.py

Runs the ``chip_smoke.py`` phases (same checks, same widths: N=10, nx=33,
nu=24, ng=32, f32 at matmul precision 'highest') and prints their numbers:

- ``batch1_cold_p50/p99_ms``: one solve from scratch, 2 SQP x 10 IPM;
- ``batch1_warm_p50/p99_ms``: the real-time-iteration tick (1 SQP x 6 IPM)
  warm-started from the previous solution shifted one node;
- ``loop_replans_per_s``: the 20-tick on-device MPC loop;
- ``fleet_solves_per_s``: a batch of 1024 solves (2 SQP x 10 IPM), and
  the useful GFLOP/s that rate implies (analytic count per solve,
  ``utils/flop_counts.py``; no device peak is assumed).

Every timing is host wall time around calls ended by ``block_until_ready``.
The legged N=67 task is not run: its configuration files are not in the
repository yet (ROADMAP 2.1). Without a GPU the script exits non-zero.
"""

import json

import jax

import chip_smoke as smoke
from cheeta_mpc.utils.flop_counts import centroidal_solve_flops


def main() -> None:
    dev = smoke.phase_device()
    card = dev.device_kind
    cold = smoke.phase_cold(card, smoke.reference_grf())
    warm = smoke.phase_warm(card, cold)
    loop = smoke.phase_loop(card)
    fleet = smoke.phase_fleet(card, cold)
    flops = centroidal_solve_flops(smoke.HORIZON, 33, 24, 32,
                                   smoke.COLD.iterations,
                                   smoke.COLD.ipm.iters)
    print(json.dumps({
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "horizon": smoke.HORIZON,
        "matmul_precision": smoke.COLD.matmul_precision,
        "batch1_cold_p50_ms": cold["p50_ms"],
        "batch1_cold_p99_ms": cold["p99_ms"],
        "batch1_cold_compile_s": cold["compile_s"],
        "batch1_warm_p50_ms": warm["p50_ms"],
        "batch1_warm_p99_ms": warm["p99_ms"],
        "loop_replans_per_s": loop["replans_per_s"],
        "fleet_batch": fleet["batch"],
        "fleet_solves_per_s": fleet["solves_per_s"],
        "fleet_useful_gflop_per_s": fleet["solves_per_s"] * flops / 1e9,
        "grf_err_vs_f64_cpu_N": cold["err_vs_f64_N"],
        "fleet_elem0_vs_batch1_N": fleet["err_vs_batch1_N"],
    }))


if __name__ == "__main__":
    main()
