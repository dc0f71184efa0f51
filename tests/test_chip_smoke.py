"""chip_smoke.py's phases at a tiny size on the CPU.

The f32 solves run on the CPU backend and phase 1 compares them with the f64
CPU reference, exactly as the script does on the GPU; the ``--cards`` path
runs on 4 of the conftest's virtual CPU devices. On a machine with no GPU
the script itself must exit non-zero and print no result.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke

REPO = Path(__file__).resolve().parents[1]
H = 4  # horizon: small enough for CPU compiles, still switches contact pairs
CARD = "cpu"


@pytest.fixture(scope="module")
def cold():
    return chip_smoke.phase_cold(CARD, chip_smoke.reference_grf(H),
                                 horizon=H, reps=2)


def test_phase_cold_matches_f64_reference(cold):
    assert cold["grf"].shape == (4, 3, H)
    assert cold["err_vs_f64_N"] <= chip_smoke.GRF_TOL
    assert cold["p99_ms"] >= cold["p50_ms"] > 0.0


def test_phase_warm_tick(cold):
    out = chip_smoke.phase_warm(CARD, cold, horizon=H, reps=2)
    assert out["p99_ms"] >= out["p50_ms"] > 0.0


def test_phase_loop_supports_weight():
    out = chip_smoke.phase_loop(CARD, horizon=H, n_ticks=3, reps=2)
    assert out["replans_per_s"] > 0.0


def test_phase_fleet_element0_matches_batch1(cold):
    out = chip_smoke.phase_fleet(CARD, cold, horizon=H, batch=8, reps=2)
    assert out["grf"].shape == (8, 4, 3, H)
    assert out["err_vs_batch1_N"] <= chip_smoke.GRF_TOL
    # Element 0 is the batch-1 scenario; the others are perturbed.
    assert np.abs(out["grf"][1] - out["grf"][0]).max() > 0.0


def test_cards_4_matches_one_device():
    out = chip_smoke.phase_cards(CARD, n_cards=4, horizon=H, batch=8)
    assert out["err_vs_1_device_N"] <= chip_smoke.GRF_TOL
    assert out["n_converged"] > 0


def test_check_failure_exits_nonzero():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.check(False, "boom")
    assert "boom" in str(exc.value.code)


def test_script_fails_without_gpu():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
