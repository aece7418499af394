"""Share of the wall in which the card is idle, in %: 1 - busy / wall a
frame, busy from the profiled stretch and wall from an unprofiled stretch
of as many frames right before it in the same run."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not run.get("unprofiled_wall_s"):
        return None
    busy = tr["busy_s"] / tr["frames"]
    wall = run["unprofiled_wall_s"] / tr["frames"]
    return 100.0 * (1.0 - busy / wall)
