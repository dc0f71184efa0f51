from cheeta_mpc.gait.motion_phase import (  # noqa: F401
    contact_flags_of_mode,
    mode_number,
    mode_name,
)
from cheeta_mpc.gait.schedule import (  # noqa: F401
    GaitSchedule,
    ModeSchedule,
    ModeSequenceTemplate,
)
from cheeta_mpc.gait.swing import (  # noqa: F401
    CubicSpline,
    SplineCpg,
    SwingTrajectoryPlanner,
)
