"""The local pytree-dataclass helper (core/struct.py) and the import path
it frees from flax."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cheeta_mpc.core import struct
from cheeta_mpc.models.centroidal import CentroidalParams

REPO = Path(__file__).resolve().parents[1]


@struct.dataclass
class _Node:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = struct.field(pytree_node=False, default=2)


def test_replace_and_frozen():
    x = _Node(a=np.ones(2), b=np.zeros(3))
    y = x.replace(b=np.ones(3), n=5)
    assert (y.n, x.n) == (5, 2)
    np.testing.assert_array_equal(y.b, np.ones(3))
    np.testing.assert_array_equal(x.b, np.zeros(3))
    with pytest.raises(AttributeError):
        x.a = np.zeros(2)


def test_static_fields_key_the_treedef_and_jit_cache():
    x = _Node(a=np.ones(2), b=np.zeros(3))
    leaves, treedef = jax.tree_util.tree_flatten(x)
    assert len(leaves) == 2  # a, b in field order; n is metadata
    np.testing.assert_array_equal(leaves[0], np.ones(2))
    assert jax.tree_util.tree_unflatten(treedef, leaves).n == 2
    assert treedef == jax.tree_util.tree_structure(x.replace(a=np.zeros(2)))
    assert treedef != jax.tree_util.tree_structure(x.replace(n=3))

    traces = []

    @jax.jit
    def f(node):
        traces.append(node.n)
        return node.a.sum() * node.n

    assert float(f(x)) == 4.0
    assert float(f(x.replace(a=np.full(2, 2.0)))) == 8.0  # cache hit
    assert float(f(x.replace(n=3))) == 6.0  # static change retraces
    assert traces == [2, 3]
    p = CentroidalParams.create(8.0, 4, 0.01, np.full(4, 0.8))
    assert len(jax.tree_util.tree_leaves(p)) == 3
    assert p.replace(num_legs=2).nu == 12


def test_package_imports_without_flax():
    code = ("import sys; sys.modules['flax'] = None; "
            "import cheeta_mpc, cheeta_mpc.mpc.centroidal_mpc, "
            "cheeta_mpc.parallel.mesh; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
