from cheeta_mpc.utils.timing import RepeatedTimer, Benchmarker  # noqa: F401
