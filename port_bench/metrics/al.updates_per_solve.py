"""al.updates_per_solve: the AL multiplier updates of the window's solves
(``launches.read_al_updates``: the running lanes whose multipliers a body
call updated, counted on the device since the traced window's start),
over the window's solves; nothing where the program keeps no such
count."""


def read(run):
    try:
        from ddp_generator_tpu_torch import launches
    except ImportError:
        return None
    if not hasattr(launches, "read_al_updates") or not run.solves:
        return None
    return launches.read_al_updates() / len(run.solves)
