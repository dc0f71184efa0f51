"""chip_smoke.py's phases at full width on an NVIDIA GPU.

Skips where the first JAX device is not a GPU (decided in a fixture, so
every pytest worker collects the same tests). On a machine with a card:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_hardware.py -n 0

One worker only: each JAX process reserves most of the card's memory.
"""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"no GPU (first JAX device: {dev.platform})")
    return dev.device_kind


@pytest.fixture(scope="module")
def cold(card):
    return chip_smoke.phase_cold(card, chip_smoke.reference_grf())


def test_gpu_cold_solve_matches_f64_cpu(cold):
    assert cold["err_vs_f64_N"] <= chip_smoke.GRF_TOL


def test_gpu_warm_tick(card, cold):
    chip_smoke.phase_warm(card, cold)


def test_gpu_on_device_loop(card):
    chip_smoke.phase_loop(card)


def test_gpu_fleet_matches_batch1(card, cold):
    out = chip_smoke.phase_fleet(card, cold)
    assert out["err_vs_batch1_N"] <= chip_smoke.GRF_TOL


def test_gpu_tf32_precision_is_finite(card, cold):
    chip_smoke.phase_precision(card, cold)
