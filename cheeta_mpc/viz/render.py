"""Render captured run data to a PNG — the last meter of the reference's
visualization stack.

The reference ends in rviz pixels (LeggedRobotVisualizer.cpp:75-369 publishes
feet spheres, force arrows, CoP, support polygon and desired-vs-optimized
trajectories; VisualizationHelpers.cpp:34-151 builds the markers). Headless
CI has no rviz, so the pixels come from matplotlib: this module turns a
:class:`cheeta_mpc.viz.helpers.LeggedVisualizer` capture (or the
``*_traj.npz`` written by ``cli/legged_demo.py``) into a four-panel figure:

1. top-down XY: per-leg foot paths, final support polygon, CoM path, CoP path
2. per-leg vertical contact force vs time
3. base height vs time
4. base roll / pitch vs time

Chart conventions (dataviz method): leg identity uses a fixed categorical
hue order (LF, RF, RH, LH -> blue, orange, aqua, yellow — never re-assigned
when a leg's series is absent), one axis per panel (height and attitude are
different units, so they get separate panels instead of a dual axis), 2 px
lines, recessive grid, legend plus direct labels, text in ink colors rather
than series colors.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Fixed categorical hue order (validated default palette, light mode).
LEG_NAMES = ("LF", "RF", "RH", "LH")
LEG_COLORS = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100")
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
GRID = "#e4e3df"


def _load_run(source) -> Dict[str, np.ndarray]:
    """Normalize a run record: LeggedVisualizer, a LeggedVisualizer .npz, or
    a legged_demo ``*_traj.npz`` -> dict with times/states/feet/forces/
    contact_flags (+ optional cop, desired_com)."""
    from cheeta_mpc.viz.helpers import LeggedVisualizer
    if isinstance(source, LeggedVisualizer):
        d = {
            "times": np.array([f.time for f in source.frames]),
            "states": np.stack([f.state for f in source.frames]),
            "feet": np.stack([f.feet for f in source.frames]),
            "forces": np.stack([f.forces for f in source.frames]),
            "contact_flags": np.stack([f.contact_flags
                                       for f in source.frames]),
            "cop": np.stack([f.cop for f in source.frames]),
        }
        if source.frames and source.frames[0].desired_com is not None:
            d["desired_com"] = np.stack([f.desired_com
                                         for f in source.frames])
        return d
    data = dict(np.load(source, allow_pickle=False))
    # legged_demo's *_traj.npz records n+1 times/states/feet but n inputs
    # (run_dummy_loop returns one input per tick): trim every per-sample
    # array to the common length so downstream indexing lines up.
    n = min(len(v) for v in data.values())
    data = {k: v[:n] for k, v in data.items()}
    if "contact_flags" not in data:
        data["contact_flags"] = (data["forces"][:, :, 2] > 1e-6).astype(float)
    return data


def render_run(source, out_path: str, title: str = "cheeta_mpc run",
               dpi: int = 130) -> Dict[str, list]:
    """Render a captured run to ``out_path`` (PNG). Returns the panel ->
    series manifest (used by tests to assert content)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = _load_run(source)
    t = d["times"]
    xs = d["states"]
    feet = d["feet"]
    forces = d["forces"]
    flags = d["contact_flags"]
    from cheeta_mpc.viz.helpers import center_of_pressure, support_polygon
    if "cop" in d:
        cop = d["cop"]
    else:
        cop = np.stack([center_of_pressure(feet[i], forces[i])
                        for i in range(len(t))])

    manifest: Dict[str, list] = {}
    fig, axes = plt.subplots(2, 2, figsize=(11, 8), dpi=dpi)
    fig.patch.set_facecolor(SURFACE)
    fig.suptitle(title, color=INK, fontsize=13)

    for ax in axes.ravel():
        ax.set_facecolor(SURFACE)
        ax.grid(True, color=GRID, linewidth=0.8)
        ax.tick_params(colors=INK_2, labelsize=8)
        for s in ax.spines.values():
            s.set_color(GRID)

    # ---- panel 1: top-down XY ----------------------------------------------
    ax = axes[0, 0]
    series = []
    poly = support_polygon(feet[-1], flags[-1])
    if len(poly) >= 3:
        ax.fill(poly[:, 0], poly[:, 1], color=GRID, alpha=0.6, zorder=0,
                label="_")
        series.append("support polygon")
    for i, (name, c) in enumerate(zip(LEG_NAMES, LEG_COLORS)):
        ax.plot(feet[:, i, 0], feet[:, i, 1], color=c, linewidth=2,
                label=name)
        series.append(f"foot path {name}")
    ax.plot(xs[:, 6], xs[:, 7], color=INK, linewidth=2)
    ax.annotate("CoM", (xs[-1, 6], xs[-1, 7]), color=INK, fontsize=8,
                xytext=(4, 4), textcoords="offset points")
    series.append("CoM path")
    ax.plot(cop[:, 0], cop[:, 1], color=INK_2, linewidth=1.5,
            linestyle="--")
    ax.annotate("CoP", (cop[-1, 0], cop[-1, 1]), color=INK_2, fontsize=8,
                xytext=(4, -10), textcoords="offset points")
    series.append("CoP path")
    if "desired_com" in d:
        dc = d["desired_com"]
        ax.plot(dc[:, 0], dc[:, 1], color=INK_2, linewidth=1.5,
                linestyle=":")
        ax.annotate("desired CoM", (dc[-1, 0], dc[-1, 1]), color=INK_2,
                    fontsize=8, xytext=(4, 10), textcoords="offset points")
        series.append("desired CoM path")
    ax.set_title("top-down: feet, CoM, CoP, support polygon", color=INK,
                 fontsize=10)
    ax.set_xlabel("x [m]", color=INK_2, fontsize=8)
    ax.set_ylabel("y [m]", color=INK_2, fontsize=8)
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best", fontsize=7, frameon=False, labelcolor=INK_2)
    manifest["topdown"] = series

    # ---- panel 2: per-leg vertical force -----------------------------------
    ax = axes[0, 1]
    for i, (name, c) in enumerate(zip(LEG_NAMES, LEG_COLORS)):
        ax.plot(t, forces[:, i, 2], color=c, linewidth=2, label=name)
    ax.set_title("contact force Fz per leg", color=INK, fontsize=10)
    ax.set_xlabel("t [s]", color=INK_2, fontsize=8)
    ax.set_ylabel("Fz [N]", color=INK_2, fontsize=8)
    ax.legend(loc="best", fontsize=7, frameon=False, labelcolor=INK_2)
    manifest["forces"] = [f"Fz {n}" for n in LEG_NAMES]

    # ---- panel 3: base height ----------------------------------------------
    ax = axes[1, 0]
    ax.plot(t, xs[:, 8], color=INK, linewidth=2)
    ax.set_title("base height", color=INK, fontsize=10)
    ax.set_xlabel("t [s]", color=INK_2, fontsize=8)
    ax.set_ylabel("z [m]", color=INK_2, fontsize=8)
    manifest["height"] = ["base z"]

    # ---- panel 4: base attitude (same unit -> one axis) --------------------
    ax = axes[1, 1]
    # state euler block is ZYX at x[9:12] = (yaw, pitch, roll).
    ax.plot(t, xs[:, 10], color=LEG_COLORS[0], linewidth=2, label="pitch")
    ax.plot(t, xs[:, 11], color=LEG_COLORS[1], linewidth=2, label="roll")
    ax.set_title("base attitude", color=INK, fontsize=10)
    ax.set_xlabel("t [s]", color=INK_2, fontsize=8)
    ax.set_ylabel("angle [rad]", color=INK_2, fontsize=8)
    ax.legend(loc="best", fontsize=7, frameon=False, labelcolor=INK_2)
    manifest["attitude"] = ["pitch", "roll"]

    fig.tight_layout(rect=(0, 0, 1, 0.96))
    fig.savefig(out_path, facecolor=SURFACE)
    plt.close(fig)
    return manifest
