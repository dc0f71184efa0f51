from cheeta_mpc.viz.helpers import (LeggedVisualizer,  # noqa: F401
                                    center_of_pressure, support_polygon)
