"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/XLA; the runtime around it (transport, policy
buffers) is native C++ like the reference's, compiled on first use with the
toolchain baked into the image (g++). A pure-Python fallback keeps tests
running if no compiler is available.
"""

from cheeta_mpc.native.build import load_policy_bus  # noqa: F401
