"""Solver options left after the plain-XLA port: the QP backends are the
Riccati scan and the condensed oracle; nothing imports a TPU kernel."""

import ast
from pathlib import Path

import numpy as np
import pytest

from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings, solve_nonlinear_ocp

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("option", ["qp_backend", "eq_backend"])
def test_retired_kernel_options_are_rejected(option):
    if option == "qp_backend":
        with pytest.raises(ValueError, match="riccati_pallas"):
            solve_nonlinear_ocp(
                linearize=None, performance=None,
                x_init=np.zeros((3, 2)), u_init=np.zeros((2, 1)),
                settings=ScpSettings(qp_backend="riccati_pallas"))
    else:
        assert "eq_backend" not in IpmSettings._fields
        with pytest.raises(TypeError):
            IpmSettings(eq_backend="pallas")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_tpu_kernel_or_flax_imports():
    files = sorted((REPO / "cheeta_mpc").rglob("*.py")) + [
        REPO / "bench.py", REPO / "chip_smoke.py"]
    bad = [(f.relative_to(REPO), m) for f in files
           for m in _imported_modules(f)
           if m.startswith(("jax.experimental.pallas.tpu", "flax"))]
    assert not bad
