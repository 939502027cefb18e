"""solved_per_s: lanes that ended in a success exit (status 1 or 2),
summed over every solve of the window, over the window's whole length
(its start to the end of its last solve)."""


def read(run):
    if not run.solves or run.window_s <= 0.0:
        return None
    return run.solved / run.window_s
