from cheeta_mpc.models.centroidal import (  # noqa: F401
    CentroidalParams,
    centroidal_step,
    pack_state,
    unpack_state,
)
