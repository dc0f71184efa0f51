from cheeta_mpc.transport.bus import MessageBus  # noqa: F401
from cheeta_mpc.transport.mpc_mrt import (  # noqa: F401
    MpcNode,
    MrtNode,
)
from cheeta_mpc.transport.wire import (  # noqa: F401
    decode_observation,
    decode_policy,
    encode_observation,
    encode_policy,
)
