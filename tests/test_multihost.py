"""Multi-host (multi-process) scaling path: 2 processes x 4 virtual CPU
devices, one global 8-device mesh over the jax.distributed runtime.

The single-host dry run exercises single-process batch sharding but not
the multi-host runtime. Here two OS processes meet at a local coordinator
(`jax.distributed.initialize`), build a global mesh, feed host-local batch
shards (`host_local_batch_to_global`) and run the sharded centroidal solve — the
same wiring a real 2-host cluster uses, minus the physical network.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # NLP-oracle/subprocess tier: run with --runslow

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "/root/repo")
import numpy as np
import jax.numpy as jnp

proc_id = int(sys.argv[1])
port = sys.argv[2]
from cheeta_mpc.parallel.mesh import (host_local_batch_to_global,
                                      initialize_distributed,
                                      make_global_mesh,
                                      sharded_batch_solver)
initialize_distributed(coordinator_address=f"localhost:{port}",
                       num_processes=2, process_id=proc_id)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

from cheeta_mpc.examples import TEST_WEIGHTS, make_example_inputs
from cheeta_mpc.mpc.centroidal_mpc import (CentroidalMpcConfig,
                                           build_centroidal_solver)
from cheeta_mpc.ops.ocpqp import IpmSettings
from cheeta_mpc.solvers.scp import ScpSettings

cfg = CentroidalMpcConfig(mass=8.0, num_legs=4, horizon=4, dt=0.01,
                          weights=tuple(TEST_WEIGHTS), mu=(0.8,) * 4,
                          dtype=jnp.float32)
mesh = make_global_mesh()
solve = sharded_batch_solver(
    build_centroidal_solver(cfg, ScpSettings(iterations=2,
                                             ipm=IpmSettings(iters=6))),
    mesh)
# Global batch 16, each process contributes its local half (seeded by the
# GLOBAL batch so both processes agree on the data).
state, des_state, des_inputs = make_example_inputs(cfg, batch=16)
lo, hi = proc_id * 8, (proc_id + 1) * 8
local = tuple(jnp.asarray(a[lo:hi], cfg.dtype)
              for a in (state, des_state, des_inputs))
args = host_local_batch_to_global(mesh, local)
with mesh:
    sol = solve(*args)
    jax.block_until_ready(sol)
# Each process sees its addressable shards; check them.
force_local = np.concatenate([
    np.asarray(s.data) for s in sol.contact_force.addressable_shards])
assert np.isfinite(force_local).all()
fz = np.abs(force_local[:, :, 2, :]).mean()
print(f"proc {proc_id}: ok, local mean |Fz| = {fz:.3f}")
"""


def test_two_process_global_mesh(tmp_path):
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    port = "12395"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
    procs = [subprocess.Popen([sys.executable, str(worker_py), str(i), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i}: ok" in out, out[-2000:]
