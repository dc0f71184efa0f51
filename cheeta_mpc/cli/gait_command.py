"""Gait command node (reference LeggedRobotGaitCommandNode +
GaitKeyboardPublisher, ocs2_legged_robot_ros/src/gait/
GaitKeyboardPublisher.cpp:46-74): loads the gait library from gait.info and
publishes the selected mode-sequence template.

Usage:
    python -m cheeta_mpc.cli.gait_command [gait.info path] [--bus NAME]

Then type a gait name (stance, trot, flying_trot, ...) per line.

With ``--bus NAME`` the command attaches to a LIVE ``cli/launch.py``
topology's shared-memory bus and publishes each selection on the
``mpc_mode_schedule`` topic (the reference's `_mpc_mode_schedule` pub/sub
path, consumed solver-synchronized by the planner's GaitReceiver). Without a
bus, the selection goes to the ``on_command`` callback (library use) — the
keyboard-to-solver pipeline of GaitKeyboardPublisher either way.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

DEFAULT_GAIT_INFO = \
    "/root/reference/ocs2_legged_robot/config/command/gait.info"


def run(gait_info_path: str = DEFAULT_GAIT_INFO,
        on_command: Optional[Callable] = None,
        stdin=None, stdout=None, bus: Optional[str] = None) -> None:
    from cheeta_mpc.utils.info_config import load_gait_library
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    library = load_gait_library(gait_info_path)
    names = list(library)
    client = None
    shm = None
    if bus is not None:
        from cheeta_mpc.transport.mpc_mrt import TOPICS, CommandClient
        from cheeta_mpc.transport.shm import ShmMessageBus
        shm = ShmMessageBus(TOPICS, bus)  # attach to the live topology
        client = CommandClient(shm)
        print(f"attached to live bus {bus}", file=stdout)
    try:
        print(f"Gait library: {', '.join(names)}", file=stdout)
        print("Enter a gait name (Ctrl-D to quit):", file=stdout)
        for line in stdin:
            name = line.strip().lower()
            if not name:
                continue
            if name not in library:
                print(f"unknown gait '{name}' "
                      f"(choose from {', '.join(names)})", file=stdout)
                continue
            template = library[name]
            if client is not None:
                client.publish_gait(name, template)
            if on_command is not None:
                on_command(name, template)
            print(f"commanded gait '{name}' "
                  f"(cycle {template.duration:.2f} s, "
                  f"{len(template.mode_sequence)} phases)", file=stdout)
    finally:
        if shm is not None:
            shm.close()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("gait_info", nargs="?", default=DEFAULT_GAIT_INFO)
    ap.add_argument("--bus", default=None,
                    help="shared-memory bus name of a running "
                         "cli/launch.py topology to publish into")
    args = ap.parse_args(argv)
    run(args.gait_info, bus=args.bus)
    return 0


if __name__ == "__main__":
    sys.exit(main())
